"""STARK prover: device stages between Fiat-Shamir squeezes.

Port of `plonky2_bn254_tpu/prover/prove.py`.  The stages run eagerly on the
device of the trace tensor.  The transcript runs either on the host
(`Challenger`: each cap and opening pulled, each challenge a python int that
enters the tensor ops as a scalar) or on the device (`DeviceChallenger`:
challenges are 0-d tensors, one pull at the end); both flows share the
stage code and give the same proof:

  S1 commit(trace)                 -> coeffs/LDE/Merkle levels/cap
  S2 aux(trace, beta, gamma)       -> LogUp helpers+Z, CTL Z  -> commit
  S3 quotient(ldes, challenges)    -> alpha-combined quotient chunks -> commit
  S4 openings(coeffs, zeta)        -> f_i(zeta), f_i(zeta*g)
  S5 fri(ldes, openings, alpha)    -> reduced oracle F + fold layers + trees

Commits go through the hand kernels: iNTT (K3), coset LDE (K4) and the
Merkle sponge (K1); the FRI grind uses K2, and each transition of the
device transcript is one K2t launch.

On a mesh (`prove(..., mesh=...)`, `parallel/mesh.py`) every rank runs
either flow on its contiguous block of the rows: the commits take the mesh
iNTT and rate-1 LDE (`parallel/ntt.py`: all-to-alls around local K3
transforms) and a sharded Merkle tree (K1), and the stages exchange only
what crosses a block edge: suffix-sum totals, the next-row halo, opening
partial sums, caps or subtree roots, and the one FRI column every rank then
folds alike.  Every rank absorbs the same gathered caps, so every rank's
transcript (host or device) is the same.  On a 2-D mesh the rows split
over one axis or over both, and the trace's columns may split over the
other axis until its commit gathers whole rows.  Every rank returns the
same proof, equal to the single-device one.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from ..field import goldilocks as gl
from ..field import ntt, ntt_cuda
from ..field.extension import Ext, GLExt
from ..interop import tensor_from_u64, u64_from_tensor
from ..parallel import ntt as pntt
from ..parallel.mesh import Mesh, Mesh2D, all_gather, exchange, shard_rows
from ..starks.air import GL, ConstraintConsumer, GLRing
from ..starks.table import KeyedLookup, Stark
from ..utils import timing as timing_mod
from . import constraints as cons
from . import device_challenger as dcm
from . import fri as fri_mod
from .challenger import Challenger
from .config import StarkConfig
from .merkle import ShardedTree, device_tree_levels, gather_paths_dev, sharded_tree
from .poly_batch import bit_rev_perm_dev, leaf_rows, sharded_leaf_rows

# Rows of the LDE coset per quotient chunk: bounds the plain-torch
# temporaries of the constraint evaluation.
QUOTIENT_CHUNK = 1 << 14


def _dev_vec(values, device) -> torch.Tensor:
    """Python ints (u64 values) -> int64 tensor on `device`."""
    return tensor_from_u64(np.array([int(v) % (1 << 64) for v in values], dtype=np.uint64),
                           device)


def ext_scale(v: Ext, k) -> Ext:
    """Ext tensor times a scalar extension value: a host `GLExt`, or an
    `Ext` of 0-d tensors (a device challenge)."""
    k1w = gl.mul_const(k.c1, 7) if isinstance(k.c1, torch.Tensor) else 7 * k.c1 % gl.P
    return Ext(
        gl.add(gl.mul(v.c0, k.c0), gl.mul(v.c1, k1w)),
        gl.add(gl.mul(v.c0, k.c1), gl.mul(v.c1, k.c0)),
    )


def _mod_dot(mat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """sum_j mat[..., j] * vec[j] mod p via log-depth pairwise reduction."""
    prod = gl.mul(mat, vec)
    n = prod.shape[-1]
    while n > 1:
        half = n // 2
        prod = gl.add(prod[..., :half], prod[..., half : 2 * half])
        n = half
    return prod[..., 0]


def _ext_powers(z, n: int, device) -> Ext:
    """[z^0 .. z^{n-1}] by doubling concatenation."""
    pows = Ext.one((1,), device)
    cur = z
    while pows.c0.shape[0] < n:
        scaled = ext_scale(pows, cur)
        pows = Ext(torch.cat([pows.c0, scaled.c0]), torch.cat([pows.c1, scaled.c1]))
        cur = cur * cur
    return Ext(pows.c0[:n], pows.c1[:n])


def _rev_cumsum(values: torch.Tensor, mesh: Mesh = None) -> torch.Tensor:
    """Reversed inclusive prefix sum mod p along the last axis, by doubling
    (torch.cumsum would add mod 2^64).  On a mesh the axis is split in
    blocks: each rank adds the totals of the later ranks' blocks."""
    acc = values.flip(-1)
    d = 1
    n = acc.shape[-1]
    while d < n:
        acc = torch.cat([acc[..., :d], gl.add(acc[..., d:], acc[..., :-d])], dim=-1)
        d *= 2
    acc = acc.flip(-1)
    if mesh is None:
        return acc
    totals = all_gather(mesh, acc[..., :1], axis=-1)  # [..., D]: each block's total
    later = totals[..., mesh.rank + 1 :]
    if later.shape[-1] == 0:
        return acc
    return gl.add(acc, cons.tree_reduce0(later.movedim(-1, 0))[..., None])


@functools.lru_cache(maxsize=None)
def _domain_arrays(n_log: int, rate_bits: int, device: torch.device):
    """(xs, inv_z_h, z_last, l_first, l_last) on the LDE coset, per device."""
    n = 1 << n_log
    big_n_log = n_log + rate_bits
    N = 1 << big_n_log
    shift = gl.MULTIPLICATIVE_GROUP_GENERATOR
    g_big_pows = tensor_from_u64(ntt._coset_powers(N, gl.primitive_root_of_unity(big_n_log)),
                                 device)
    xs = gl.mul_const(g_big_pows, shift)
    g2 = pow(gl.primitive_root_of_unity(big_n_log), n, gl.P)
    shift_n = pow(shift, n, gl.P)
    xn_period = tensor_from_u64(ntt._coset_powers(1 << rate_bits, g2), device)
    xn = gl.mul_const(xn_period.repeat(N >> rate_bits), shift_n)
    z_h = gl.sub(xn, 1)
    inv_z_h = gl.batch_inv(z_h)
    g = gl.primitive_root_of_unity(n_log)
    g_last = pow(g, n - 1, gl.P)
    z_last = gl.sub(xs, g_last)
    n_inv = gl.h_inv(n)
    l_first = gl.mul(z_h, gl.batch_inv(gl.mul_const(gl.sub(xs, 1), n)))
    l_last = gl.mul(gl.mul_const(z_h, g_last * n_inv % gl.P), gl.batch_inv(z_last))
    return xs, inv_z_h, z_last, l_first, l_last


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------


def commit_values(values: torch.Tensor, config: StarkConfig, tt=None, mesh: Mesh = None):
    """[k, n] values -> (coeffs [k, n], LDE [k, N], Merkle levels); on a
    mesh each of them is this rank's block and the tree a `ShardedTree`."""
    tt = timing_mod.get(tt)
    with tt.scope("intt"):
        coeffs = (ntt_cuda.intt(values.contiguous()) if mesh is None
                  else pntt.mesh_intt(values, mesh))
    with tt.scope("lde"):
        lde = _lde(coeffs, config, mesh)
    with tt.scope("merkle"):
        levels = _tree(lde, config, mesh)
    return coeffs, lde, levels


def commit_trace(values: torch.Tensor, config: StarkConfig, tt=None, mesh: Mesh = None,
                 col_mesh: Mesh = None):
    """The trace commit: (values, coeffs, LDE, Merkle levels).  With
    `col_mesh` the trace's columns are split over it too: the iNTT and LDE
    run on this rank's [w/T, n/D] block over `mesh` (columns are
    independent), then one gather over `col_mesh` regroups the values, the
    coefficients and the LDE into whole rows, since a Merkle leaf is a whole
    row and every later stage reads whole rows."""
    if col_mesh is None:
        return (values, *commit_values(values, config, tt, mesh))
    tt = timing_mod.get(tt)
    with tt.scope("intt"):
        coeffs = pntt.mesh_intt(values, mesh)
    with tt.scope("lde"):
        lde = _lde(coeffs, config, mesh)
    with tt.scope("column gather"):
        nb = values.shape[1]
        whole = all_gather(col_mesh, torch.cat([values, coeffs, lde], dim=1), axis=0)
        values, coeffs, lde = (x.contiguous() for x in whole.split([nb, nb, 2 * nb], dim=1))
    with tt.scope("merkle"):
        levels = _tree(lde, config, mesh)
    return values, coeffs, lde, levels


def commit_coeffs(coeffs: torch.Tensor, config: StarkConfig, mesh: Mesh = None):
    """[k, n] coefficients -> (LDE [k, N], Merkle levels)."""
    lde = _lde(coeffs, config, mesh)
    return lde, _tree(lde, config, mesh)


def _lde(coeffs: torch.Tensor, config: StarkConfig, mesh: Mesh = None) -> torch.Tensor:
    if mesh is None:
        return ntt_cuda.coset_lde(coeffs.contiguous(), config.rate_bits)
    return pntt.mesh_coset_lde_rate1(coeffs, mesh)


def _tree(lde: torch.Tensor, config: StarkConfig, mesh: Mesh = None):
    if mesh is None:
        return device_tree_levels(leaf_rows(lde), config.cap_height)
    return sharded_tree(sharded_leaf_rows(lde, mesh), config.cap_height, mesh)


def _cap(levels) -> torch.Tensor:
    return levels.cap if isinstance(levels, ShardedTree) else levels[-1]


def _make_aux(stark: Stark, mesh: Mesh = None):
    """Aux-column pipeline: LogUp helper pairs and Z per lookup, CTL Z per
    CTL, for each challenge set; pointwise in the rows but for the Z
    columns' suffix sums (`_rev_cumsum`, across the mesh's blocks)."""

    def aux_core(trace_cols, betas, gammas, ctl_weight_specs):
        """betas/gammas: python ints per challenge; ctl_weight_specs: per
        challenge, per ctl, (col_idx [k], weights [k]) tensors."""
        dev = trace_cols.device

        def idx(cols):
            return torch.tensor(list(cols), dtype=torch.int64).to(dev, non_blocking=True)

        aux = []
        for i in range(len(ctl_weight_specs)):
            gamma_c = gammas[i]
            beta_c = betas[i]
            for lk in stark.lookups:
                filt_idx = None
                if isinstance(lk, KeyedLookup):
                    cols = gl.add(
                        gl.add(trace_cols[idx(k for k, _ in lk.pairs)],
                               gl.mul(trace_cols[idx(v for _, v in lk.pairs)], beta_c)),
                        gamma_c,
                    )
                    table_raw = gl.add(
                        gl.add(trace_cols[lk.table_key_col],
                               gl.mul(trace_cols[lk.table_val_col], beta_c)),
                        gamma_c,
                    )
                    filt_idx = getattr(lk, "filters", None)
                else:
                    cols = gl.add(trace_cols[idx(lk.columns)], gamma_c)
                    table_raw = gl.add(trace_cols[lk.table_col], gamma_c)
                inv_cols = gl.batch_inv(cols)
                if filt_idx is not None:
                    # helper terms become filter/(gamma+entry); None = unfiltered
                    filt = torch.stack([
                        trace_cols[f] if f is not None else torch.ones_like(trace_cols[0])
                        for f in filt_idx
                    ])
                    inv_cols = gl.mul(inv_cols, filt)
                even = inv_cols[0::2]
                odd = inv_cols[1::2]
                if odd.shape[0] < even.shape[0]:
                    odd = torch.cat([odd, torch.zeros_like(even[:1])], dim=0)
                helpers = gl.add(even, odd)
                table_inv = gl.batch_inv(table_raw)
                freq = trace_cols[lk.freq_col]
                aux.append(helpers)
                h_sum = cons.tree_reduce0(helpers)
                contribution = gl.sub(h_sum, gl.mul(freq, table_inv))
                aux.append(_rev_cumsum(contribution, mesh)[None])
            for c_idx, ctl in enumerate(stark.ctls):
                col_idx, weights = ctl_weight_specs[i][c_idx]
                weighted = gl.mul(trace_cols[col_idx], weights[:, None])
                acc = gl.add(cons.tree_reduce0(weighted), gamma_c)
                filt = trace_cols[ctl.filter_col]
                aux.append(_rev_cumsum(gl.mul(filt, gl.batch_inv(acc)), mesh)[None])
        return torch.cat(aux, dim=0)

    return aux_core


def _make_quotient(stark: Stark, n_log: int, config: StarkConfig, mesh: Mesh = None):
    """Quotient evaluation in LDE-point chunks, then Z_H division, iNTT and
    the degree split.  On a mesh the LDEs are this rank's blocks: the next
    row crosses the block edge (`_next_rows`), the iNTT is the mesh one, and
    the degree split reshards N-blocks to n-blocks (`_split_degree`)."""
    n = 1 << n_log
    rate = config.rate_bits
    N = n << rate
    step = 1 << rate
    D = 1 if mesh is None else mesh.size
    lo_block = 0 if mesh is None else mesh.rank * (N // D)
    C = min(N // D, QUOTIENT_CHUNK)
    shift_inv_pows_np = ntt._coset_powers(N, gl.h_inv(gl.MULTIPLICATIVE_GROUP_GENERATOR))
    ctl_static_cols = tuple(
        tuple(c for c, _ in ctl.flat_weights(1, gl.P)) for ctl in stark.ctls
    )

    def chunk_eval(t_loc, t_nxt, a_loc, a_nxt, zl, lf, ll,
                   alphas, alpha_pows, challenges, ctl_totals, weight_arrays):
        ring = GLRing((t_loc.shape[1],), t_loc.device)
        local = [GL(t_loc[j]) for j in range(t_loc.shape[0])]
        next_ = [GL(t_nxt[j]) for j in range(t_nxt.shape[0])]
        aux_local = [GL(a_loc[j]) for j in range(a_loc.shape[0])]
        aux_next = [GL(a_nxt[j]) for j in range(a_nxt.shape[0])]
        consumer = ConstraintConsumer(
            ring, [ring.const(a) for a in alphas], GL(zl), GL(lf), GL(ll),
            alpha_pows=alpha_pows,
        )
        cons.eval_all_constraints(
            consumer, ring, stark, local, next_, aux_local, aux_next,
            challenges, ctl_totals,
            ctl_weight_specs=(ctl_static_cols, weight_arrays),
        )
        return torch.stack([acc.v for acc in consumer.accs])

    def quotient_core(t_lde, a_lde, alphas, alpha_pows, challenges, ctl_totals,
                      weight_arrays):
        dev = t_lde.device
        block = slice(lo_block, lo_block + N // D)
        _, inv_z_h, z_last, l_first, l_last = (a[block] for a in _domain_arrays(n_log, rate, dev))
        t_nxt = _next_rows(t_lde, step, mesh)
        a_nxt = _next_rows(a_lde, step, mesh)
        acc_parts = []
        for lo in range(0, N // D, C):
            sl = slice(lo, lo + C)
            acc_parts.append(
                chunk_eval(
                    t_lde[:, sl], t_nxt[:, sl], a_lde[:, sl], a_nxt[:, sl],
                    z_last[sl], l_first[sl], l_last[sl],
                    alphas, alpha_pows, challenges, ctl_totals, weight_arrays,
                )
            )
        accs = torch.cat(acc_parts, dim=1)
        shift_inv_pows = tensor_from_u64(shift_inv_pows_np[block], dev)
        q_vals = gl.mul(accs, inv_z_h[None])
        q_vals = ntt_cuda.intt(q_vals) if mesh is None else pntt.mesh_intt(q_vals, mesh)
        q_coeffs = gl.mul(q_vals, shift_inv_pows[None])
        if mesh is not None:
            return _split_degree(q_coeffs, mesh)
        return torch.stack([half for q in q_coeffs for half in (q[:n], q[n:])])

    return quotient_core


def _next_rows(lde: torch.Tensor, step: int, mesh: Mesh = None) -> torch.Tensor:
    """The LDE at the next row's points, x -> x g: a roll by `step` points;
    on a mesh the first `step` points of the next rank's block (rank 0's
    for the last rank) close this rank's block."""
    if mesh is None:
        return torch.roll(lde, -step, dims=1)
    heads = all_gather(mesh, lde[:, :step], axis=1)  # [k, D * step]
    nxt = (mesh.rank + 1) % mesh.size
    return torch.cat([lde[:, step:], heads[:, nxt * step : (nxt + 1) * step]], dim=1)


def _split_degree(q: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block [k, N/D] of the quotient polynomials' N
    coefficients -> its block [2k, n/D] of their halves (q[:n], q[n:]) per
    polynomial, as the single-device split orders them.  Rank r = h D/2 + a
    holds half h's coefficients [2a, 2a + 2) n/D: its two n/D pieces go to
    ranks 2a and 2a + 1; rank t receives half 0 from rank t // 2 and half 1
    from rank D/2 + t // 2."""
    D, r = mesh.size, mesh.rank
    k, nb2 = q.shape
    nb = nb2 // 2
    a = r % (D // 2)
    empty = q.new_empty((k, 0))
    pieces = [empty] * D
    pieces[2 * a], pieces[2 * a + 1] = q[:, :nb], q[:, nb:]
    sources = (r // 2, D // 2 + r // 2)
    got = exchange(mesh, pieces, [(k, nb) if s in sources else (k, 0) for s in range(D)])
    return torch.stack([got[sources[0]], got[sources[1]]], dim=1).reshape(2 * k, nb)


def _times_const(z, c: int):
    """A host `GLExt` or an `Ext` of 0-d tensors times the residue `c`."""
    if isinstance(z, GLExt):
        return z.scalar_mul(c)
    return Ext(gl.mul_const(z.c0, c), gl.mul_const(z.c1, c))


def _ext_pow(z, e: int):
    """z^e for a host `GLExt` or an `Ext` of 0-d tensors (square and
    multiply)."""
    if isinstance(z, GLExt):
        return z.exp(e)
    acc = Ext.one((), z.c0.device)
    while e:
        if e & 1:
            acc = acc * z
        e >>= 1
        if e:
            z = z * z
    return acc


def _block_offsets(zeta, g: int, nb: int, mesh: Mesh = None):
    """(zeta^k, (zeta g)^k) for k = r nb, the power at which rank r's block
    of nb coefficients starts: once per proof (for a device zeta a chain of
    ~log2 k squarings), shared by the six `_openings` calls; (None, None)
    off a mesh."""
    if mesh is None:
        return None, None
    k = mesh.rank * nb
    zk = _ext_pow(zeta, k)
    return zk, _times_const(zk, pow(g, k, gl.P))


def _openings(coeffs: torch.Tensor, z, mesh: Mesh = None, offset=None):
    """[2, k]: (c0, c1) of f_i(z) for every row of `coeffs` ([k, n]); `z` a
    host `GLExt` or an `Ext` of 0-d tensors.  On a mesh `coeffs` is this
    rank's block [k, n/D] and `offset` = z^(r n/D) (`_block_offsets`): each
    rank sums its terms z^(r n/D + t) c_t, and the D partial sums are
    gathered and added mod p."""
    p = _ext_powers(z, coeffs.shape[-1], coeffs.device)
    if mesh is not None:
        p = ext_scale(p, offset)
    out = torch.stack([_mod_dot(coeffs, p.c0), _mod_dot(coeffs, p.c1)])
    if mesh is None:
        return out
    return cons.tree_reduce0(all_gather(mesh, out[None], axis=0))


@functools.lru_cache(maxsize=None)
def _xs_np(N: int):
    return ntt._coset_powers(N, gl.primitive_root_of_unity(N.bit_length() - 1))


def _ext_const(z, device) -> Ext:
    """A host `GLExt` as an `Ext` of 0-d tensors on `device`; an `Ext` as is."""
    if isinstance(z, Ext):
        return z
    return Ext(torch.full((), gl.i64(z.c0), dtype=torch.int64, device=device),
               torch.full((), gl.i64(z.c1), dtype=torch.int64, device=device))


def _fri_oracle(lde_batches, alpha_pows, s_zeta, s_zeta_g, zeta, zeta_g, alpha_off,
                mesh: Mesh = None):
    """F = (S - S(zeta)) / (x - zeta) + alpha^n (S - S(zeta g)) / (x - zeta g)
    on the LDE coset, with S = sum_j alpha^j f_j.  `alpha_pows`: [n_polys, 2]
    rows (c0, c1) of alpha^j (a tensor, or host values); the scalars are host
    `GLExt`s or `Ext`s of 0-d tensors.  On a mesh the LDEs are this rank's
    blocks, and every rank gets the whole F (one gather of [2, N])."""
    dev = lde_batches[0].device
    N = lde_batches[0].shape[-1]
    block = slice(0, N) if mesh is None else slice(mesh.rank * N, (mesh.rank + 1) * N)
    if not isinstance(alpha_pows, torch.Tensor):
        alpha_pows = tensor_from_u64(np.array(alpha_pows, dtype=np.uint64), dev)
    s_zeta, s_zeta_g, zeta, zeta_g, alpha_off = (
        _ext_const(z, dev) for z in (s_zeta, s_zeta_g, zeta, zeta_g, alpha_off))
    S0 = torch.zeros(N, dtype=torch.int64, device=dev)
    S1 = torch.zeros(N, dtype=torch.int64, device=dev)
    off = 0
    for lde in lde_batches:
        k = lde.shape[0]
        ap = alpha_pows[off : off + k]
        # f_j are base-field: (alpha^j * f_j).c0 = p0_j f_j, .c1 = p1_j f_j
        S0 = gl.add(S0, cons.tree_reduce0(gl.mul(lde, ap[:, 0:1])))
        S1 = gl.add(S1, cons.tree_reduce0(gl.mul(lde, ap[:, 1:2])))
        off += k
    assert off == alpha_pows.shape[0]
    n_all = N if mesh is None else N * mesh.size
    xs = gl.mul_const(tensor_from_u64(_xs_np(n_all)[block], dev),
                      gl.MULTIPLICATIVE_GROUP_GENERATOR)

    def reduced(point: Ext, s_at: Ext) -> Ext:
        d0 = gl.sub(xs, point.c0)
        d1 = gl.neg(point.c1).expand_as(xs)
        norm = gl.sub(gl.square(d0), gl.mul_const(gl.square(d1), 7))
        ninv = gl.batch_inv(norm)
        inv_diff = Ext(gl.mul(d0, ninv), gl.mul(gl.neg(d1), ninv))
        num = Ext(gl.sub(S0, s_at.c0), gl.sub(S1, s_at.c1))
        return num * inv_diff

    b = reduced(zeta, s_zeta)
    bg = ext_scale(reduced(zeta_g, s_zeta_g), alpha_off)
    F = Ext(gl.add(b.c0, bg.c0), gl.add(b.c1, bg.c1))
    if mesh is None:
        return F
    return Ext(*all_gather(mesh, torch.stack(F), axis=1))


# ---------------------------------------------------------------------------
# proof container
# ---------------------------------------------------------------------------


@dataclass
class Openings:
    trace_zeta: List[GLExt]
    trace_zeta_g: List[GLExt]
    aux_zeta: List[GLExt]
    aux_zeta_g: List[GLExt]
    quotient_zeta: List[GLExt]
    quotient_zeta_g: List[GLExt]

    def all_polys_order(self):
        return (
            (self.trace_zeta, self.trace_zeta_g),
            (self.aux_zeta, self.aux_zeta_g),
            (self.quotient_zeta, self.quotient_zeta_g),
        )


@dataclass
class Proof:
    degree_bits: int
    trace_cap: np.ndarray
    aux_cap: np.ndarray
    quotient_cap: np.ndarray
    openings: Openings
    fri: fri_mod.FriProof
    query_indices: List[int]
    query_initials: List[List]
    fri_query_layers: List[List[fri_mod.FriLayerProof]]


# ---------------------------------------------------------------------------
# main prover
# ---------------------------------------------------------------------------


def prove(
    stark: Stark,
    trace_rows: torch.Tensor,
    ctl_values: Dict[int, List[List[int]]],
    config: StarkConfig,
    timing: "timing_mod.TimingTree" = None,
    device_fs: bool = None,
    mesh=None,
    mesh_axis=None,
    col_axis: str = None,
) -> Proof:
    """Prove `trace_rows` ([n, width] int64 residues) on its device.

    `device_fs` keeps the Fiat–Shamir transcript on the device
    (`_prove_device_fs`); None, the default, means device FS for a trace on
    CUDA and the host challenger on the CPU or on a mesh, as the reference
    defaults to its device flow on one accelerator.  Both flows give the
    same proof.

    `mesh` (`parallel.mesh.make_mesh` or `make_mesh2d`): every rank of the
    mesh calls `prove` with the whole trace (on any device, the host
    included) and keeps only its block of the rows, on `mesh.device`; every
    rank returns the same proof, equal to the single-device one.  On a 2-D
    mesh `mesh_axis` names the axis the rows split over, or an ordered
    tuple of axes to split them over both (default "tp", as the
    reference's); `col_axis` names an axis the trace's columns split over
    for the trace commit's iNTT and LDE, or none (replicated) when the width
    does not divide its size, as in the reference.  Ranks that differ only
    along an axis neither names do the same work.  The mesh path takes rate
    1 (as the reference's explicit mesh path), and needs the D ranks the
    rows split over to be a power of two >= 2 with n a multiple of D^2.
    """
    tt = timing_mod.get(timing)
    n, w = trace_rows.shape
    assert w == stark.width
    n_log = n.bit_length() - 1
    assert n == 1 << n_log
    rate = config.rate_bits
    mesh, col_mesh = _resolve_mesh(mesh, mesh_axis, col_axis, w)
    if mesh is None:
        dev = trace_rows.device
        trace_cols = trace_rows.T.contiguous()
        if device_fs is None:
            device_fs = dev.type == "cuda"
    else:
        _check_mesh(mesh, n, config)
        dev = mesh.device
        trace_cols = shard_rows(mesh, trace_rows).T.contiguous()
        if col_mesh is not None:
            trace_cols = shard_rows(col_mesh, trace_cols)
    if device_fs:
        return _prove_device_fs(stark, trace_cols, ctl_values, config, tt, n_log, mesh,
                                col_mesh)

    # ---- S1: trace commit ---------------------------------------------
    with tt.scope("trace commit"):
        trace_cols, t_coeffs, t_lde, t_levels = commit_trace(trace_cols, config, tt, mesh,
                                                             col_mesh)
        trace_cap = u64_from_tensor(_cap(t_levels))
    ch = Challenger()
    ch.observe_element(n_log)
    ch.observe_cap(trace_cap)

    challenges = [
        (ch.get_challenge(), ch.get_challenge()) for _ in range(config.num_challenges)
    ]
    # per (challenge, ctl) column indices and weights
    ctl_weight_specs = [
        [
            (
                torch.tensor([c for c, _ in ctl.flat_weights(b, gl.P)], dtype=torch.int64,
                             device=dev),
                _dev_vec([wt for _, wt in ctl.flat_weights(b, gl.P)], dev),
            )
            for ctl in stark.ctls
        ]
        for (b, _) in challenges
    ]

    # ---- S2: aux columns + commit -------------------------------------
    with tt.scope("aux"):
        aux_cols = _make_aux(stark, mesh)(
            trace_cols, [b for b, _ in challenges], [g for _, g in challenges],
            ctl_weight_specs,
        )
        a_coeffs, a_lde, a_levels = commit_values(aux_cols, config, mesh=mesh)
        aux_cap = u64_from_tensor(_cap(a_levels))
    ch.observe_cap(aux_cap)
    del aux_cols, trace_cols  # queries read the LDEs, not the values

    ctl_totals = [
        [cons.ctl_total(ctl_values[c_idx], b, g) for c_idx in range(len(stark.ctls))]
        for (b, g) in challenges
    ]
    alphas = ch.get_n_challenges(config.num_challenges)

    # ---- S3: quotient --------------------------------------------------
    with tt.scope("quotient"):
        alpha_pows = tensor_from_u64(
            np.stack([gl.powers(a, 513) for a in alphas]), dev
        )
        q_chunks = _make_quotient(stark, n_log, config, mesh)(
            t_lde, a_lde, alphas, alpha_pows, challenges, ctl_totals,
            [[wt for (_, wt) in per_ch] for per_ch in ctl_weight_specs],
        )
        q_lde, q_levels = commit_coeffs(q_chunks, config, mesh)
        quotient_cap = u64_from_tensor(_cap(q_levels))
    ch.observe_cap(quotient_cap)

    # ---- S4: openings --------------------------------------------------
    zeta = ch.get_extension_challenge()
    g = gl.primitive_root_of_unity(n_log)
    zeta_g = zeta.scalar_mul(g)

    with tt.scope("openings"):
        offsets = _block_offsets(zeta, g, t_coeffs.shape[-1], mesh)
        openings = _openings_from_rows([
            u64_from_tensor(_openings(coeffs, z, mesh, off))
            for coeffs in (t_coeffs, a_coeffs, q_chunks)
            for z, off in zip((zeta, zeta_g), offsets)
        ])
    del t_coeffs, a_coeffs  # openings done; only LDEs are queried below
    for vals, vals_g in openings.all_polys_order():
        for v in vals:
            ch.observe_extension(v)
        for v in vals_g:
            ch.observe_extension(v)

    # ---- S5: FRI -------------------------------------------------------
    fri_alpha = ch.get_extension_challenge()
    vals_zeta = openings.trace_zeta + openings.aux_zeta + openings.quotient_zeta
    vals_zeta_g = openings.trace_zeta_g + openings.aux_zeta_g + openings.quotient_zeta_g
    n_polys = len(vals_zeta)

    def horner(vals):
        acc = GLExt.zero()
        for v in reversed(vals):
            acc = acc * fri_alpha + v
        return acc

    apow = GLExt.one()
    alpha_pows_rows = []
    for _ in range(n_polys):
        alpha_pows_rows.append([apow.c0, apow.c1])
        apow = apow * fri_alpha
    with tt.scope("fri oracle"):
        F = _fri_oracle(
            [t_lde, a_lde, q_lde], alpha_pows_rows, horner(vals_zeta),
            horner(vals_zeta_g), zeta, zeta_g, fri_alpha.exp(n_polys), mesh,
        )

    with tt.scope("fri"):
        fri_proof, query_indices, fri_query_layers = fri_mod.prove_fri(
            F, n_log, config, ch, timing=tt
        )

    # initial tree openings per query: rows and sibling paths gathered on
    # the device; only ~Q * (width + 4 * height) values reach the host.
    with tt.scope("query extraction"):
        query_initials = _query_initials(
            query_indices, ((t_lde, t_levels), (a_lde, a_levels), (q_lde, q_levels)),
            n_log + rate, dev, mesh)

    return Proof(
        degree_bits=n_log,
        trace_cap=trace_cap,
        aux_cap=aux_cap,
        quotient_cap=quotient_cap,
        openings=openings,
        fri=fri_proof,
        query_indices=query_indices,
        query_initials=query_initials,
        fri_query_layers=fri_query_layers,
    )


def _resolve_mesh(mesh, mesh_axis, col_axis, width: int):
    """(the 1-D mesh the rows split over, the 1-D mesh the trace's columns
    split over or None) for `prove`'s mesh arguments."""
    if mesh is None:
        if mesh_axis is not None or col_axis is not None:
            raise ValueError("prove: mesh_axis and col_axis need a mesh")
        return None, None
    if isinstance(mesh, Mesh):
        if col_axis is not None or mesh_axis not in (None, mesh.axis):
            raise ValueError(f"prove: a 1-D mesh over {mesh.axis!r} has no axis "
                             f"{mesh_axis!r} or {col_axis!r}")
        return mesh, None
    if not isinstance(mesh, Mesh2D):
        raise TypeError(f"prove: mesh must be a parallel.mesh Mesh or Mesh2D, got {type(mesh)}")
    rows = mesh.sub("tp" if mesh_axis is None else mesh_axis)
    if col_axis is None:
        return rows, None
    if col_axis in rows.axis.split(","):
        raise ValueError(f"prove: col_axis {col_axis!r} is an axis the rows split over")
    cols = mesh.sub(col_axis)
    return rows, (cols if width % cols.size == 0 else None)


def _check_mesh(mesh: Mesh, n: int, config: StarkConfig) -> None:
    D = mesh.size
    if config.rate_bits != 1:
        raise ValueError(f"prove: the mesh path needs rate_bits = 1, got {config.rate_bits}")
    if D < 2 or D & (D - 1):
        raise ValueError(f"prove: the mesh needs a power of two >= 2 ranks, got {D}")
    if n % (D * D):
        raise ValueError(f"prove: {n} rows are not a multiple of D^2 = {D * D}")


def _query_rows_paths(idx: torch.Tensor, batches, n_big_log: int, mesh: Mesh = None):
    """Per (LDE, tree) batch, (rows [Q, k], sibling digests [Q, 4] per
    level) of the queried leaves `idx` (a [Q] tensor), gathered on the
    device; on a mesh the row comes from the rank whose LDE block holds the
    point, the path from the rank whose leaf block holds the leaf
    (`ShardedTree.paths`)."""
    nat = bit_rev_perm_dev(n_big_log, idx.device)[idx]
    out = []
    for lde, levels in batches:
        if mesh is None:
            out.append((lde[:, nat].T, gather_paths_dev(levels, idx)))
            continue
        nb = lde.shape[-1]
        every = all_gather(mesh, lde[:, nat % nb].T[None], axis=0)  # [D, Q, k]
        rows = every[nat // nb, torch.arange(idx.shape[0], device=idx.device)]
        out.append((rows, levels.paths(idx, mesh)))
    return out


def _query_initials(query_indices, batches, n_big_log: int, dev, mesh: Mesh = None):
    """Per query, the queried leaf row and its Merkle path in each batch
    (`_query_rows_paths` of host query indices), on the host."""
    idx = torch.from_numpy(np.array(query_indices, dtype=np.int64)).to(dev)
    out = [(u64_from_tensor(rows), [u64_from_tensor(p) for p in paths])
           for rows, paths in _query_rows_paths(idx, batches, n_big_log, mesh)]
    return _per_query(out, len(query_indices))


def _openings_from_rows(rows) -> Openings:
    """Openings from six [2, k] host arrays (c0, c1 rows) in transcript
    order: trace, aux, quotient, each at zeta then zeta * g."""

    def mk(r):
        return [GLExt(int(a), int(b)) for a, b in zip(r[0], r[1])]

    return Openings(*(mk(r) for r in rows))


def _per_query(batches, n_queries: int):
    """Per query, (row, [sibling per level]) of each (rows [Q, w], paths
    [height][Q, 4]) batch."""
    return [
        [(rows[qi], [lvl[qi] for lvl in paths]) for rows, paths in batches]
        for qi in range(n_queries)
    ]


# ---------------------------------------------------------------------------
# device Fiat-Shamir: the transcript transitions and the flow
# ---------------------------------------------------------------------------


def _fs1(ch, stark: Stark, n_log: int, nc: int, cap, ctl_rows):
    """Absorb the degree and the trace cap; squeeze (beta, gamma) per
    challenge set; the CTL weights and extra looking totals they give."""
    ch.observe_element(n_log)
    ch.observe_cap(cap)
    pairs = ch.get_n_challenges(2 * nc).reshape(nc, 2)  # (beta, gamma) per set
    betas, gammas = pairs[:, 0], pairs[:, 1]
    weights = [dcm.ctl_weights_device(stark, b) for b in betas]
    return betas, gammas, weights, dcm.ctl_totals_device(ctl_rows, betas, gammas)


def _fs2(ch, nc: int, cap):
    """Absorb the aux cap; squeeze the constraint alphas and their powers."""
    ch.observe_cap(cap)
    alphas = ch.get_n_challenges(nc)
    return alphas, torch.stack([dcm.powers_vec(a, 513) for a in alphas])


def _fs3(ch, cap) -> Ext:
    """Absorb the quotient cap; squeeze zeta."""
    ch.observe_cap(cap)
    return Ext(*ch.get_n_challenges(2))


def _fs4(ch, opens):
    """Absorb the six [2, k] opening batches ((c0, c1) per value, transcript
    order) and squeeze the FRI alpha, one transition.  Returns its powers [n_polys, 2], the
    combined openings S(zeta) and S(zeta g) and alpha^n_polys."""
    for o in opens:
        ch.observe_flat(o.T.reshape(-1))
    fa0, fa1 = ch.get_n_challenges(2)
    n_polys = sum(o.shape[1] for o in opens[0::2])
    apow = dcm.ext_powers_rows(fa0, fa1, n_polys + 1)
    a0, a1 = apow[:n_polys, 0], apow[:n_polys, 1]

    def combined(batches) -> Ext:
        v0, v1 = torch.cat(batches, dim=1)
        return Ext(cons.tree_reduce0(gl.add(gl.mul(v0, a0), gl.mul_const(gl.mul(v1, a1), 7))),
                   cons.tree_reduce0(gl.add(gl.mul(v0, a1), gl.mul(v1, a0))))

    return apow[:n_polys], combined(opens[0::2]), combined(opens[1::2]), Ext(*apow[n_polys])


def _pull_once(tree):
    """Every tensor of a nested dict / list / tuple to the host in one
    device-to-host copy: numpy uint64 arrays, in the same nesting (tuples
    become lists)."""
    flat = []

    def collect(x):
        if isinstance(x, torch.Tensor):
            flat.append(x)
        else:
            for v in (x.values() if isinstance(x, dict) else x):
                collect(v)

    collect(tree)
    host = u64_from_tensor(torch.cat([t.reshape(-1).to(torch.int64) for t in flat]))
    off = 0

    def rebuild(x):
        nonlocal off
        if isinstance(x, torch.Tensor):
            arr = host[off : off + x.numel()].reshape(x.shape)
            off += x.numel()
            return arr
        if isinstance(x, dict):
            return {k: rebuild(v) for k, v in x.items()}
        return [rebuild(v) for v in x]

    return rebuild(tree)


def _prove_device_fs(stark: Stark, trace_cols: torch.Tensor, ctl_values, config: StarkConfig,
                     tt, n_log: int, mesh: Mesh = None, col_mesh: Mesh = None) -> Proof:
    """`prove` with the transcript on the device (`DeviceChallenger`): caps,
    challenges and openings stay there, the stages follow one another on the
    device's queue, and the proof reaches the host in one pull at the end;
    the grind pulls one `found` flag per batch.  The same stage code as the
    host flow, with 0-d tensors for the challenges, so the same proof.  On a
    mesh every rank runs its own challenger on the gathered caps, openings
    and FRI column, so all of them draw the same challenges; the
    exchanges, which gloo stages through the host, synchronise."""
    rate = config.rate_bits
    nc = config.num_challenges
    dev = trace_cols.device
    ch = dcm.DeviceChallenger(dev)
    ctl_rows = [dcm.ctl_rows_device(ctl_values[c], dev) for c in range(len(stark.ctls))]
    ctl_cols = [
        torch.tensor([c for c, _ in ctl.flat_weights(1, gl.P)], dtype=torch.int64).to(
            dev, non_blocking=True)
        for ctl in stark.ctls
    ]

    # ---- S1: trace commit + fs1 -----------------------------------------
    with tt.scope("trace commit"):
        trace_cols, t_coeffs, t_lde, t_levels = commit_trace(trace_cols, config, tt, mesh,
                                                             col_mesh)
    with tt.scope("fs1"):
        betas, gammas, weights, totals = _fs1(ch, stark, n_log, nc, _cap(t_levels), ctl_rows)
    ctl_weight_specs = [list(zip(ctl_cols, weights[i])) for i in range(nc)]

    # ---- S2: aux + commit + fs2 -------------------------------------------
    with tt.scope("aux"):
        aux_cols = _make_aux(stark, mesh)(trace_cols, list(betas), list(gammas),
                                          ctl_weight_specs)
        a_coeffs, a_lde, a_levels = commit_values(aux_cols, config, mesh=mesh)
    del aux_cols, trace_cols  # queries read the LDEs, not the values
    with tt.scope("fs2"):
        alphas, alpha_pows = _fs2(ch, nc, _cap(a_levels))

    # ---- S3: quotient + commit + fs3 --------------------------------------
    with tt.scope("quotient"):
        q_chunks = _make_quotient(stark, n_log, config, mesh)(
            t_lde, a_lde, list(alphas), alpha_pows, list(zip(betas, gammas)), totals,
            [[wt for _, wt in per_ch] for per_ch in ctl_weight_specs],
        )
        q_lde, q_levels = commit_coeffs(q_chunks, config, mesh)
    with tt.scope("fs3"):
        zeta = _fs3(ch, _cap(q_levels))
    g = gl.primitive_root_of_unity(n_log)
    zeta_g = _times_const(zeta, g)

    # ---- S4: openings + fs4 -----------------------------------------------
    with tt.scope("openings"):
        offsets = _block_offsets(zeta, g, t_coeffs.shape[-1], mesh)
        opens = [
            _openings(coeffs, z, mesh, off)
            for coeffs in (t_coeffs, a_coeffs, q_chunks)
            for z, off in zip((zeta, zeta_g), offsets)
        ]
    del t_coeffs, a_coeffs  # openings done; only LDEs are queried below
    with tt.scope("fs4"):
        apow, s_zeta, s_zeta_g, alpha_off = _fs4(ch, opens)

    # ---- S5: FRI ------------------------------------------------------------
    with tt.scope("fri oracle"):
        F = _fri_oracle([t_lde, a_lde, q_lde], apow, s_zeta, s_zeta_g, zeta, zeta_g, alpha_off,
                        mesh)
    with tt.scope("fri"):
        res = fri_mod.prove_fri_device(F, n_log, config, ch, timing=tt)

    with tt.scope("query extraction"):
        q_idx = res["q_idx"]
        init = _query_rows_paths(
            q_idx, ((t_lde, t_levels), (a_lde, a_levels), (q_lde, q_levels)), n_log + rate, mesh)

    # ---- the one pull -------------------------------------------------------
    with tt.scope("final pull"):
        host = _pull_once({
            "caps": [_cap(t_levels), _cap(a_levels), _cap(q_levels)], "opens": opens,
            "fri_caps": res["caps"], "final": res["final"], "nonce": res["nonce"],
            "pow_ok": res["pow_ok"], "q_idx": q_idx, "init": init, "layers": res["layers"],
        })
    assert bool(host["pow_ok"]), "the device proof-of-work check failed"

    query_indices = [int(v) for v in host["q_idx"]]
    fc0, fc1 = host["final"]
    fri_query_layers = [
        [
            fri_mod.FriLayerProof(group_values=rows[qi].reshape(1 << a, 2),
                                  path=[lvl[qi] for lvl in paths])
            for (rows, paths), (_, _, a) in zip(host["layers"], res["layers_cfg"])
        ]
        for qi in range(len(query_indices))
    ]
    trace_cap, aux_cap, quotient_cap = host["caps"]
    return Proof(
        degree_bits=n_log,
        trace_cap=trace_cap,
        aux_cap=aux_cap,
        quotient_cap=quotient_cap,
        openings=_openings_from_rows(host["opens"]),
        fri=fri_mod.FriProof(
            layer_caps=host["fri_caps"],
            final_coeffs=[GLExt(int(a), int(b)) for a, b in zip(fc0, fc1)],
            pow_nonce=int(host["nonce"]),
        ),
        query_indices=query_indices,
        query_initials=_per_query(host["init"], len(query_indices)),
        fri_query_layers=fri_query_layers,
    )
