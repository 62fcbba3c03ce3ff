"""Batched Goldilocks NTT / inverse NTT / coset LDE on torch tensors.

Port of `plonky2_bn254_tpu/field/ntt.py`.  All transforms run along the LAST
axis of `[..., n]` residue tensors: bit-reverse, then radix-2 DIT stages
with host-built twiddle tables.  These are the plain versions of the hand
kernels in `ntt_cuda.py`, which the prover calls.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..interop import tensor_from_u64
from . import goldilocks as gl


@functools.lru_cache(maxsize=None)
def _bit_reverse_perm(n_log: int) -> np.ndarray:
    n = 1 << n_log
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(n_log):
        rev |= ((idx >> b) & 1) << (n_log - 1 - b)
    return rev


@functools.lru_cache(maxsize=None)
def _stage_twiddles(n_log: int, inverse: bool) -> tuple:
    """Per DIT stage s (blocks of m = 2^s): w_m^j for j in [0, m/2), numpy u64."""
    tables = []
    for s in range(1, n_log + 1):
        m = 1 << s
        w = gl.primitive_root_of_unity(s)
        if inverse:
            w = pow(w, m - 1, gl.P)
        tables.append(gl.powers(w, m // 2))
    return tuple(tables)


@functools.lru_cache(maxsize=None)
def _device_tables(n_log: int, inverse: bool, device: torch.device):
    perm = torch.from_numpy(_bit_reverse_perm(n_log)).to(device)
    tws = [tensor_from_u64(t, device) for t in _stage_twiddles(n_log, inverse)]
    return perm, tws


def _dit(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    n = x.shape[-1]
    n_log = n.bit_length() - 1
    assert n == 1 << n_log, "NTT size must be a power of two"
    perm, tws = _device_tables(n_log, inverse, x.device)
    x = x[..., perm]
    for s in range(1, n_log + 1):
        m = 1 << s
        y = x.reshape(x.shape[:-1] + (n // m, 2, m // 2))
        even = y[..., 0, :]
        odd = gl.mul(y[..., 1, :], tws[s - 1])
        x = torch.cat([gl.add(even, odd), gl.sub(even, odd)], dim=-1)
        x = x.reshape(y.shape[:-3] + (n,))
    return x


def ntt(x: torch.Tensor) -> torch.Tensor:
    """Forward NTT along the last axis (natural order in and out): the
    polynomial with coefficients `x[..., i]` evaluated at g^k."""
    if x.shape[-1] == 1:
        return x
    return _dit(x, inverse=False)


def intt(x: torch.Tensor) -> torch.Tensor:
    """Inverse NTT along the last axis: values -> coefficients."""
    n = x.shape[-1]
    if n == 1:
        return x
    return gl.mul(_dit(x, inverse=True), pow(n, gl.P - 2, gl.P))


@functools.lru_cache(maxsize=None)
def _coset_powers(n: int, shift: int) -> np.ndarray:
    return gl.powers(shift, n)


def coset_lde_from_coeffs(coeffs: torch.Tensor, rate_bits: int,
                          shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR) -> torch.Tensor:
    n = coeffs.shape[-1]
    powers = tensor_from_u64(_coset_powers(n, shift), coeffs.device)
    shifted = gl.mul(coeffs, powers)
    pad = coeffs.new_zeros(coeffs.shape[:-1] + ((n << rate_bits) - n,))
    return ntt(torch.cat([shifted, pad], dim=-1))


# ---------------------------------------------------------------------------
# Host-side reference (python ints) for tests
# ---------------------------------------------------------------------------


def h_ntt(values) -> np.ndarray:
    """Recursive host NTT over python ints (test oracle)."""

    def rec(v):
        n = len(v)
        if n == 1:
            return v
        even = rec(v[0::2])
        odd = rec(v[1::2])
        w = gl.primitive_root_of_unity(n.bit_length() - 1)
        out = [0] * n
        cur = 1
        for k in range(n // 2):
            t = (cur * odd[k]) % gl.P
            out[k] = (even[k] + t) % gl.P
            out[k + n // 2] = (even[k] - t) % gl.P
            cur = (cur * w) % gl.P
        return out

    return np.array(rec([int(v) for v in values]), dtype=np.uint64)
