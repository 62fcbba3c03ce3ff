"""Distributed Goldilocks NTT: the four-step algorithm with all-to-alls.

Port of `plonky2_bn254_tpu/parallel/ntt.py`.  Every function takes and
returns this rank's block, never a global array; the local transforms go
through `field/ntt_cuda.py` (kernel K3 on the card, its plain version on the
CPU), and the size-D DFT and the twiddles are plain tensor ops, as they are
plain `jnp` in the reference.

`distributed_ntt` (layout contract of the reference):
  input  A[N1, N2] sharded on axis 1 (columns), A[j1, j2] = x[j1*N2 + j2]
  output B[N1, N2] sharded on axis 0 (rows),    B[k1, k2] = X[k1 + k2*N1]
Equivalently B = ntt(x).reshape(N2, N1).T.

`mesh_ntt` / `mesh_intt` / `mesh_coset_lde_rate1` keep the prover's layout
on both sides: `[w, N]` in natural order, the last axis split in contiguous
blocks over the ranks (rank i holds x[iC:(i+1)C], C = N/D).  With
y[k1, j2] = sum_i A[i, j2] (w^C)^(i k1), the DFT over the device axis,

  X[k1 + D k2] = NTT_C over j2 [ w^(j2 k1) y[k1, j2] ]

and the schedule is three all-to-alls, each moving the local block once:
  a2a 1  split j2, gather i        -> [w, D(i), C/D(j2)]
  DFT_D  sum over i                -> [w, D(k1), C/D(j2)]
  a2a 2  split k1, gather j2       -> [w, C(j2)] for this rank's k1
  twiddle w^(j2 k1), local NTT_C   -> X[k1 + D k2], k2-major
  a2a 3  split k2, gather k1       -> [w, D(k1), C/D(k2')]
  local interleave                 -> the natural block [qC, (q+1)C)
Per rank on the wire: 3 * 8 w C (D-1)/D bytes a transform.  All arithmetic
is exact mod p, so the result equals the single-device transform bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..field import goldilocks as gl
from ..field import ntt as ntt_plain_mod
from ..field import ntt_cuda
from ..interop import tensor_from_u64
from .mesh import Mesh, all_to_all


# ---------------------------------------------------------------------------
# Host tables (copies of the reference's, pinned by tests/test_torch_parallel.py)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _twiddle_matrix(n1_log: int, n2_log: int, inverse: bool) -> np.ndarray:
    """omega^{j2*k1} table [N1, N2] (numpy, cached per shape)."""
    n1, n2 = 1 << n1_log, 1 << n2_log
    w = gl.primitive_root_of_unity(n1_log + n2_log)
    if inverse:
        w = gl.h_inv(w)
    out = np.empty((n1, n2), dtype=np.uint64)
    row_base = np.empty(n1, dtype=object)
    cur = 1
    for k1 in range(n1):
        row_base[k1] = cur
        cur = cur * w % gl.P
    for k1 in range(n1):
        b = int(row_base[k1])
        r = np.empty(n2, dtype=np.uint64)
        acc = 1
        for j2 in range(n2):
            r[j2] = acc
            acc = acc * b % gl.P
        out[k1] = r
    return out


@functools.lru_cache(maxsize=None)
def _dftD_matrix(n_log: int, d_log: int, inverse: bool) -> np.ndarray:
    """[D, D] matrix M[k1, i] = (w_N^C)^(i·k1) (= w_D^(i·k1)); inverse
    variant uses w_D^(-i·k1) with the 1/D factor folded in."""
    D = 1 << d_log
    wD = gl.primitive_root_of_unity(d_log)
    if inverse:
        wD = gl.h_inv(wD)
    scale = gl.h_inv(D) if inverse else 1
    out = np.empty((D, D), dtype=np.uint64)
    for k1 in range(D):
        acc = scale
        base = pow(wD, k1, gl.P)
        for i in range(D):
            out[k1, i] = acc
            acc = acc * base % gl.P
    return out


@functools.lru_cache(maxsize=None)
def _mid_twiddle(n_log: int, d_log: int, inverse: bool) -> np.ndarray:
    """[D, C] table T[k1, j2] = w_N^(±j2·k1) (the j2-major middle twiddle,
    row k1 = the slice device k1 needs after a2a#2)."""
    N, D = 1 << n_log, 1 << d_log
    C = N // D
    w = gl.primitive_root_of_unity(n_log)
    if inverse:
        w = gl.h_inv(w)
    out = np.empty((D, C), dtype=np.uint64)
    for k1 in range(D):
        base = pow(w, k1, gl.P)
        acc = 1
        row = np.empty(C, dtype=np.uint64)
        for j2 in range(C):
            row[j2] = acc
            acc = acc * base % gl.P
        out[k1] = row
    return out


@functools.lru_cache(maxsize=None)
def _rank_tables(n_log: int, d_log: int, inverse: bool, rank: int, device: torch.device):
    """(DFT_D matrix [D, D], this rank's middle twiddle row [C]) on `device`."""
    return (tensor_from_u64(_dftD_matrix(n_log, d_log, inverse), device),
            tensor_from_u64(_mid_twiddle(n_log, d_log, inverse)[rank], device))


@functools.lru_cache(maxsize=None)
def _rank_coset(n: int, shift: int, rank: int, block: int, device: torch.device):
    """shift^j for j in this rank's block [rank*block, (rank+1)*block)."""
    pows = ntt_plain_mod._coset_powers(n, shift)
    return tensor_from_u64(pows[rank * block : (rank + 1) * block], device)


def _log2(n: int, what: str) -> int:
    n_log = n.bit_length() - 1
    if n < 1 or n != 1 << n_log:
        raise ValueError(f"{what}: {n} is not a power of two")
    return n_log


# ---------------------------------------------------------------------------
# The four-step matrix transform
# ---------------------------------------------------------------------------


def distributed_ntt(blk: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Four-step NTT of A[N1, N2]: this rank's column block [N1, N2/D] in,
    its row block [N1/D, N2] of B out (layout contract above)."""
    n1, chunk = blk.shape
    D = mesh.size
    n2 = chunk * D
    n1_log, n2_log = _log2(n1, "distributed_ntt N1"), _log2(n2, "distributed_ntt N2")
    if n1 % D:
        raise ValueError(f"distributed_ntt: N1 = {n1} does not split over {D} ranks")
    tw = tensor_from_u64(
        _twiddle_matrix(n1_log, n2_log, False)[:, mesh.rank * chunk : (mesh.rank + 1) * chunk],
        blk.device)
    # local size-N1 transforms down the columns
    b = ntt_cuda.ntt(blk.T.contiguous()).T
    c = gl.mul(b, tw)
    # transpose over the mesh: [N1, N2/D] -> [N1/D, N2]
    c = all_to_all(mesh, c, split_axis=0, concat_axis=1, tiled=True)
    return ntt_cuda.ntt(c.contiguous())


def single_device_reference(x_mat: torch.Tensor) -> torch.Tensor:
    """B = ntt(flat x).reshape(N2, N1).T: the oracle of the layout contract."""
    n1, n2 = x_mat.shape
    return ntt_cuda.ntt(x_mat.reshape(1, n1 * n2))[0].reshape(n2, n1).T


# ---------------------------------------------------------------------------
# Natural-order mesh NTT / coset LDE: the prover's sharded commit path
# ---------------------------------------------------------------------------


def _check_mesh_size(N: int, D: int, what: str) -> tuple:
    n_log = _log2(N, f"{what}: N")
    d_log = _log2(D, f"{what}: mesh size")
    if N % (D * D):
        raise ValueError(f"{what}: N = {N} is not a multiple of D^2 = {D * D}")
    return n_log, d_log


def _dft_sum(b: torch.Tensor, M: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """sum over i in [lo, hi) of M[:, i] * b[:, i] as [w, D(k1), C/D]: a
    log-depth tree of `gl.add` whose products are made one leaf at a time,
    so no temporary holds all D x D products."""
    if hi - lo == 1:
        return gl.mul(b[:, None, lo, :], M[None, :, lo, None])
    mid = (lo + hi) // 2
    return gl.add(_dft_sum(b, M, lo, mid), _dft_sum(b, M, mid, hi))


def _mesh_ntt_local(blk: torch.Tensor, mesh: Mesh, n_log: int, d_log: int,
                    inverse: bool) -> torch.Tensor:
    """The per-rank body shared by mesh_ntt and mesh_coset_lde_rate1."""
    w = blk.shape[0]
    D = 1 << d_log
    C = (1 << n_log) // D
    M, tw = _rank_tables(n_log, d_log, inverse, mesh.rank, blk.device)

    # a2a 1: [w, C] -> [w, D(i), C/D(j2)], the device axis gathered locally
    b = all_to_all(mesh, blk.reshape(w, D, C // D), split_axis=1, concat_axis=1)
    # DFT_D over i
    y = _dft_sum(b, M, 0, D)  # [w, D(k1), C/D(j2)]
    # a2a 2: keep this rank's k1, gather every j2
    y = all_to_all(mesh, y, split_axis=1, concat_axis=2, tiled=True).reshape(w, C)
    z = gl.mul(y, tw)
    # local size-C transform over j2 -> X[k1 + D*k2], k2-major
    Xk = ntt_cuda.intt(z) if inverse else ntt_cuda.ntt(z)
    # a2a 3: split the k2 chunks; natural position p = k1 + D*k2'
    Xk = all_to_all(mesh, Xk.reshape(w, D, C // D), split_axis=1, concat_axis=1)
    return Xk.transpose(1, 2).reshape(w, C)


def mesh_ntt(blk: torch.Tensor, mesh: Mesh, inverse: bool = False) -> torch.Tensor:
    """NTT (or, `inverse`, iNTT with the 1/N scale) of a `[w, N]` batch in
    natural order, the last axis split over the mesh: this rank's `[w, N/D]`
    block in, its block of the result out."""
    w, C = blk.shape
    n_log, d_log = _check_mesh_size(C * mesh.size, mesh.size, "mesh_ntt")
    # the local iNTT includes 1/C; the inverse DFT_D matrix includes 1/D
    return _mesh_ntt_local(blk.contiguous(), mesh, n_log, d_log, inverse)


def mesh_intt(blk: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return mesh_ntt(blk, mesh, inverse=True)


def mesh_coset_lde_rate1(blk: torch.Tensor, mesh: Mesh,
                         shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR) -> torch.Tensor:
    """`[w, N]` coefficients (natural, last axis split over the mesh) ->
    `[w, 2N]` values on shift * H_2N, same layout: this rank's `[w, N/D]`
    block in, its `[w, 2N/D]` block out.  The even and odd output points
    are two size-N NTTs of premultiplied coefficients, interleaved; under
    contiguous blocks the interleave is local."""
    w, C = blk.shape
    N = C * mesh.size
    n_log, d_log = _check_mesh_size(N, mesh.size, "mesh_coset_lde_rate1")
    w2N = gl.primitive_root_of_unity(n_log + 1)
    outs = []
    for s in (shift, shift * w2N % gl.P):
        pre = _rank_coset(N, s, mesh.rank, C, blk.device)
        outs.append(_mesh_ntt_local(gl.mul(blk, pre), mesh, n_log, d_log, False))
    return torch.stack(outs, dim=-1).reshape(w, 2 * C)
