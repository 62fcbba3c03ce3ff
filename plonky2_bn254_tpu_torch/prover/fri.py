"""Batch FRI: commit/fold on the device, host checks.

Port of `plonky2_bn254_tpu/prover/fri.py`: `prove_fri` drives the host
challenger, `prove_fri_device` the device one (`device_challenger.py`).  The
FRI oracle is an extension-field polynomial given by its values on the LDE
coset (natural order); Merkle leaves group the 2^arity_bits sibling values
(bit-reversed order makes fold fibers contiguous).

Fold (arity A = 2^a): for the fiber {x*w^t} over y = x^A with values v_t,
interpolate q = iNTT_A(v) and emit q(beta/x) = sum_j q_j beta^j x^-j: one
batched size-A iNTT (kernel K3) and a weighted sum per layer.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..field import goldilocks as gl
from ..field import ntt_cuda, poseidon, poseidon_cuda
from ..field.extension import Ext, GLExt
from ..interop import tensor_from_u64, u64_from_tensor
from ..utils import timing as timing_mod
from .config import StarkConfig
from .device_challenger import ext_powers_rows
from .merkle import MerkleTree, device_tree_levels, gather_paths_dev, gather_rows_and_paths
from .poly_batch import bit_rev_perm, bit_rev_perm_dev


@dataclass
class FriLayerProof:
    group_values: np.ndarray  # [A, 2] uint64 (c0, c1 per value)
    path: List[np.ndarray]


@dataclass
class FriProof:
    layer_caps: List[np.ndarray]
    final_coeffs: List[GLExt]
    pow_nonce: int
    queries: list = None


@functools.lru_cache(maxsize=None)
def _inv_point_pows(m_log: int, a_bits: int, shift: int) -> np.ndarray:
    """x_i^-j for one fold layer: [A, M/A] numpy u64.  Layer domain =
    shift * <g>, |.| = M; fiber base points x_i = shift * g^i, i < M/A."""
    M = 1 << m_log
    A = 1 << a_bits
    g_inv = gl.h_inv(gl.primitive_root_of_unity(m_log))
    base = gl.powers(g_inv, M // A).astype(object) * gl.h_inv(shift) % gl.P
    out = np.empty((A, M // A), dtype=np.uint64)
    out[0] = 1
    row = np.ones(M // A, dtype=object)
    for j in range(1, A):
        row = row * base % gl.P
        out[j] = row.astype(np.uint64)
    return out


@functools.lru_cache(maxsize=None)
def _inv_point_pows_dev(m_log: int, a_bits: int, shift: int, device: torch.device):
    return tensor_from_u64(_inv_point_pows(m_log, a_bits, shift), device)


def fold_layer(values: Ext, m_log: int, a_bits: int, shift: int,
               beta_pows: torch.Tensor) -> Ext:
    """One fold: Ext values [M] natural order -> Ext values [M/A];
    `beta_pows` holds the rows (c0, c1) of beta^0 .. beta^(A-1)."""
    M = 1 << m_log
    A = 1 << a_bits
    inv_pows = _inv_point_pows_dev(m_log, a_bits, shift, values.c0.device)
    # iNTT of size A over the fiber axis: rows of the [M/A, A] transpose
    d0 = ntt_cuda.intt(values.c0.reshape(A, M // A).T.contiguous()).T
    d1 = ntt_cuda.intt(values.c1.reshape(A, M // A).T.contiguous()).T
    t0 = gl.mul(d0, inv_pows)  # [A, M/A]
    t1 = gl.mul(d1, inv_pows)
    b0, b1 = beta_pows[:, 0:1], beta_pows[:, 1:2]
    b1w = gl.mul_const(b1, 7)
    # (t0 + t1 u) * (b0 + b1 u), u^2 = 7, summed over the A axis
    acc0 = gl.add(gl.mul(t0, b0), gl.mul(t1, b1w))
    acc1 = gl.add(gl.mul(t0, b1), gl.mul(t1, b0))
    return Ext(_halving_sum(acc0), _halving_sum(acc1))


def _host_ext_powers(beta: GLExt, a_bits: int, device) -> torch.Tensor:
    """[A, 2] rows (c0, c1) of beta^0 .. beta^(A-1) from a host challenge."""
    rows = np.empty((1 << a_bits, 2), dtype=np.uint64)
    bp = GLExt.one()
    for j in range(1 << a_bits):
        rows[j] = (bp.c0, bp.c1)
        bp = bp * beta
    return tensor_from_u64(rows, device)


def _halving_sum(arr: torch.Tensor) -> torch.Tensor:
    while arr.shape[0] > 1:
        half = arr.shape[0] // 2
        arr = gl.add(arr[:half], arr[half:])
    return arr[0]


def _ext_leaves(values: Ext, m_log: int, a_bits: int) -> torch.Tensor:
    """Bit-rev group leaves: [M/A, 2A] rows (c0, c1 interleaved)."""
    M = 1 << m_log
    A = 1 << a_bits
    perm = bit_rev_perm_dev(m_log, values.c0.device)
    l0 = values.c0[perm].reshape(M // A, A)
    l1 = values.c1[perm].reshape(M // A, A)
    return torch.stack([l0, l1], dim=-1).reshape(M // A, 2 * A)


def pow_grind_device(state: torch.Tensor, pow_bits: int) -> torch.Tensor:
    """Smallest nonce whose sponge output from `state` ([12], on the device,
    input buffer empty) has `pow_bits` leading zeros, as a 0-d tensor on the
    device: one batch of 2^max(pow_bits+4, 12) permutations (kernel K2) per
    try and one pull of `found` per batch."""
    batch = 1 << max(pow_bits + 4, 12)
    start = 0
    while True:
        states = state.expand(batch, poseidon.WIDTH).clone()
        states[:, 0] = torch.arange(start, start + batch, dtype=torch.int64,
                                    device=state.device)
        out = poseidon_cuda.permute_states(states)
        ok = ((out[:, 7] >> (64 - pow_bits)) & ((1 << pow_bits) - 1)) == 0
        if bool(ok.any()):
            return start + torch.argmax(ok.to(torch.int32))  # the first hit
        start += batch


def pow_grind(challenger, pow_bits: int, device) -> int:
    """`pow_grind_device` from the host challenger's state."""
    state = torch.tensor([gl.i64(s) for s in challenger.state], dtype=torch.int64,
                         device=device)
    return int(pow_grind_device(state, pow_bits))


def pow_check(challenger, nonce: int, pow_bits: int) -> bool:
    c = challenger.fork()
    c.observe_element(nonce % gl.P)
    val = c.get_challenge()
    return (val >> (64 - pow_bits)) == 0


@functools.lru_cache(maxsize=None)
def _shift_inv_pows(final_m_log: int, final_shift: int) -> np.ndarray:
    return gl.powers(gl.h_inv(final_shift), 1 << final_m_log)


def final_poly(last: Ext, final_m_log: int, final_shift: int):
    """Coefficients of the last layer: coset iNTT (kernel K3)."""
    sp = tensor_from_u64(_shift_inv_pows(final_m_log, final_shift), last.c0.device)
    both = ntt_cuda.intt(torch.stack([last.c0, last.c1]).contiguous())
    return gl.mul(both[0], sp), gl.mul(both[1], sp)


def domain_shifts_and_sizes(n_log: int, config: StarkConfig):
    """[(m_log, shift, a)] per fold layer, and the final domain params."""
    out = []
    m_log = n_log + config.rate_bits
    shift = gl.MULTIPLICATIVE_GROUP_GENERATOR
    degree_bits = n_log
    while degree_bits > config.final_poly_degree_bits:
        a = min(config.arity_bits, degree_bits - config.final_poly_degree_bits)
        out.append((m_log, shift, a))
        shift = pow(shift, 1 << a, gl.P)
        m_log -= a
        degree_bits -= a
    return out, (m_log, shift, degree_bits)


def prove_fri(values: Ext, n_log: int, config: StarkConfig, challenger, timing=None):
    """FRI prove for one ext-valued oracle on the LDE coset (natural order).

    Returns (FriProof, query indices, per-query layer proofs).  Layer leaves
    and Merkle levels stay on the device; queried rows are gathered there.
    """
    tt = timing_mod.get(timing)
    layers_cfg, (final_m_log, final_shift, final_deg_bits) = domain_shifts_and_sizes(
        n_log, config
    )
    device = values.c0.device
    layer_values = [values]
    layer_leaves = []
    layer_levels = []
    caps = []
    with tt.scope("fri commit/fold"):
        for m_log, shift, a in layers_cfg:
            v = layer_values[-1]
            cap_h = min(config.cap_height, m_log - a)
            leaves = _ext_leaves(v, m_log, a)
            levels = device_tree_levels(leaves, cap_h)
            cap = u64_from_tensor(levels[-1])
            layer_leaves.append(leaves)
            layer_levels.append(levels)
            caps.append(cap)
            challenger.observe_cap(cap)
            beta = challenger.get_extension_challenge()
            layer_values.append(fold_layer(v, m_log, a, shift, _host_ext_powers(beta, a, device)))

    with tt.scope("fri final poly"):
        c0, c1 = final_poly(layer_values[-1], final_m_log, final_shift)
        n_final = 1 << final_deg_bits
        c0 = u64_from_tensor(c0[:n_final])
        c1 = u64_from_tensor(c1[:n_final])
        final_coeffs = [GLExt(int(c0[i]), int(c1[i])) for i in range(n_final)]
    for fc in final_coeffs:
        challenger.observe_extension(fc)

    with tt.scope("fri pow"):
        nonce = pow_grind(challenger, config.proof_of_work_bits, device)
    challenger.observe_element(nonce % gl.P)
    assert (challenger.get_challenge() >> (64 - config.proof_of_work_bits)) == 0

    big_n = 1 << (n_log + config.rate_bits)
    query_indices = [
        challenger.get_challenge() % big_n for _ in range(config.num_query_rounds)
    ]

    with tt.scope("fri query gather"):
        r = np.array(query_indices, dtype=np.int64)
        per_layer = []
        for li, (m_log, shift, a) in enumerate(layers_cfg):
            groups = r >> a
            per_layer.append(
                gather_rows_and_paths(layer_leaves[li], layer_levels[li], groups)
            )
            r = groups
        queries = []
        for qi in range(len(query_indices)):
            layer_proofs = []
            for li, (m_log, shift, a) in enumerate(layers_cfg):
                rows, paths = per_layer[li]
                layer_proofs.append(
                    FriLayerProof(
                        group_values=rows[qi].reshape(1 << a, 2),
                        path=[lvl[qi] for lvl in paths],
                    )
                )
            queries.append(layer_proofs)

    proof = FriProof(layer_caps=caps, final_coeffs=final_coeffs, pow_nonce=nonce)
    return proof, query_indices, queries


def prove_fri_device(values: Ext, n_log: int, config: StarkConfig, challenger,
                     timing=None) -> dict:
    """`prove_fri` with the transcript on the device (a `DeviceChallenger`):
    caps, betas, the final polynomial, the nonce and the query indices stay
    there, and the query indices drive the row and path gathers there.

    Returns a dict of device tensors for the proof's single pull: "caps"
    (per layer [k, 4]), "final" ([2, n_final]), "nonce", "pow_ok",
    "q_idx" ([Q]), "layers" (per layer (rows [Q, 2A], paths)), and
    "layers_cfg" (`domain_shifts_and_sizes`)."""
    tt = timing_mod.get(timing)
    layers_cfg, (final_m_log, final_shift, final_deg_bits) = domain_shifts_and_sizes(
        n_log, config
    )
    vals = values
    caps, layer_leaves, layer_levels = [], [], []
    with tt.scope("fri commit/fold"):
        for m_log, shift, a in layers_cfg:
            leaves = _ext_leaves(vals, m_log, a)
            levels = device_tree_levels(leaves, min(config.cap_height, m_log - a))
            caps.append(levels[-1])
            layer_leaves.append(leaves)
            layer_levels.append(levels)
            challenger.observe_cap(levels[-1])
            b0, b1 = challenger.get_n_challenges(2)
            vals = fold_layer(vals, m_log, a, shift, ext_powers_rows(b0, b1, 1 << a))

    with tt.scope("fri final poly"):
        c0, c1 = final_poly(vals, final_m_log, final_shift)
        n_final = 1 << final_deg_bits
        final = torch.stack([c0[:n_final], c1[:n_final]])
        challenger.observe_flat(final.T.reshape(-1))  # (c0, c1) per coefficient

    # the grind hashes the state as it stands (as the host pow_grind reads
    # challenger.state, which absorbs the final polynomial here): nothing
    # may wait in the input buffer
    pow_bits = config.proof_of_work_bits
    with tt.scope("fri pow"):
        state = challenger.state
        assert challenger.counts()[0] == 0, "input buffer not empty at the proof of work"
        nonce = pow_grind_device(state, pow_bits)
    # the nonce, the PoW check's challenge and the query indices: one transition
    challenger.observe_element(nonce)
    squeezed = challenger.get_n_challenges(1 + config.num_query_rounds)
    pow_ok = ((squeezed[0] >> (64 - pow_bits)) & ((1 << pow_bits) - 1)) == 0
    big_n = 1 << (n_log + config.rate_bits)
    q_idx = squeezed[1:] & (big_n - 1)

    with tt.scope("fri query gather"):
        layers = []
        r = q_idx
        for li, (m_log, shift, a) in enumerate(layers_cfg):
            groups = r >> a
            layers.append((layer_leaves[li][groups], gather_paths_dev(layer_levels[li], groups)))
            r = groups

    return {"caps": caps, "final": final, "nonce": nonce, "pow_ok": pow_ok, "q_idx": q_idx,
            "layers": layers, "layers_cfg": layers_cfg}


# ---------------------------------------------------------------------------
# Host verification helpers
# ---------------------------------------------------------------------------


def h_fold_group(group_values, x_base: int, beta: GLExt, a_bits: int) -> GLExt:
    """Host fold of one fiber: values in bit-rev t-order at points
    x_base * w^t -> folded value at x_base^A."""
    A = 1 << a_bits
    rev = bit_rev_perm(a_bits)
    vals_nat = [None] * A
    for j in range(A):
        c0, c1 = int(group_values[j][0]), int(group_values[j][1])
        vals_nat[int(rev[j])] = GLExt(c0, c1)
    w_inv = gl.h_inv(gl.primitive_root_of_unity(a_bits))
    n_inv = gl.h_inv(A)
    coeffs = []
    for j in range(A):
        acc = GLExt.zero()
        wp = 1
        step = pow(w_inv, j, gl.P)
        for t in range(A):
            acc = acc + vals_nat[t].scalar_mul(wp)
            wp = wp * step % gl.P
        coeffs.append(acc.scalar_mul(n_inv))
    x_inv = gl.h_inv(x_base)
    acc = GLExt.zero()
    cur = GLExt.one()
    for j in range(A):
        acc = acc + coeffs[j] * cur
        cur = cur * beta.scalar_mul(x_inv)
    return acc


def verify_fri_query(
    proof: FriProof,
    betas,
    idx: int,
    f_at_idx: GLExt,
    n_log: int,
    config: StarkConfig,
    query: List[FriLayerProof],
) -> bool:
    """Check one query path: layer consistency down to the final poly."""
    layers_cfg, (final_m_log, final_shift, final_deg_bits) = domain_shifts_and_sizes(
        n_log, config
    )
    r = idx
    cur_val = f_at_idx
    for li, (m_log, shift, a) in enumerate(layers_cfg):
        A = 1 << a
        group = r >> a
        offset = r & (A - 1)
        lp = query[li]
        got = GLExt(int(lp.group_values[offset][0]), int(lp.group_values[offset][1]))
        if got != cur_val:
            return False
        leaf = [int(v) for pair in lp.group_values for v in pair]
        digest = poseidon.h_hash_no_pad(leaf)
        if not MerkleTree.verify(digest, group, lp.path, proof.layer_caps[li]):
            return False
        g = gl.primitive_root_of_unity(m_log)
        i_nat = int(bit_rev_perm(m_log - a)[group])
        x_base = shift * pow(g, i_nat, gl.P) % gl.P
        cur_val = h_fold_group(lp.group_values, x_base, betas[li], a)
        r = group
    y_nat = int(bit_rev_perm(final_m_log)[r])
    g = gl.primitive_root_of_unity(final_m_log)
    y = final_shift * pow(g, y_nat, gl.P) % gl.P
    acc = GLExt.zero()
    for c in reversed(proof.final_coeffs):
        acc = acc.scalar_mul(y) + c
    return acc == cur_val
