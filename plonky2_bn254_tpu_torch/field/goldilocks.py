"""Goldilocks field arithmetic (p = 2^64 - 2^32 + 1) on torch int64 tensors.

Port of `plonky2_bn254_tpu/field/goldilocks.py`.  Residues are `torch.int64`
tensors holding the u64 bit pattern, because torch's unsigned types lack
add, shift and compare:

  * `+` and `*` wrap mod 2^64, exactly as they do for u64;
  * `>>` is arithmetic on int64, so every right shift is masked;
  * unsigned comparisons XOR in the sign bit first (`_ult`, `_ge_p`).

Every op follows the reference formula step by step, so it returns the same
bit pattern as its JAX counterpart for any u64 input, canonical or not.
Scalars may be python ints (u64 values); they enter the ops as kernel
arguments, never as host-to-device copies.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

P = 0xFFFFFFFF00000001  # Goldilocks prime, 2^64 - 2^32 + 1
EPSILON = 0xFFFFFFFF  # 2^64 - P = 2^32 - 1
MULTIPLICATIVE_GROUP_GENERATOR = 7
TWO_ADICITY = 32
# g = 7^((p-1)/2^32) mod p: generator of the maximal 2-adic subgroup.
POWER_OF_TWO_GENERATOR = pow(7, (P - 1) >> TWO_ADICITY, P)

_U64_MASK = (1 << 64) - 1
_MASK32 = 0xFFFFFFFF
_SIGN = -(1 << 63)


def i64(x: int) -> int:
    """A python int read as u64 -> the int64 with the same bit pattern."""
    x &= _U64_MASK
    return x - (1 << 64) if x >> 63 else x


def u64(x: int) -> int:
    """An int64 python int -> the u64 value of its bit pattern."""
    return x & _U64_MASK


_P = i64(P)
_P_FLIP = i64(P ^ (1 << 63))  # P with the sign bit flipped, for unsigned >=


# ---------------------------------------------------------------------------
# Unsigned helpers on int64 bit patterns
# ---------------------------------------------------------------------------


def _ult(a, b):
    """a < b as unsigned 64-bit values."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _ge_p(x):
    """x >= P as an unsigned 64-bit value."""
    return (x ^ _SIGN) >= _P_FLIP


def _shr32(x):
    """Logical x >> 32."""
    return (x >> 32) & _MASK32


def _halves(x):
    """(lo, hi) 32-bit halves of a tensor or of a python-int u64."""
    if isinstance(x, int):
        x = u64(x)
        return x & _MASK32, x >> 32
    return x & _MASK32, _shr32(x)


# ---------------------------------------------------------------------------
# Core elementwise ops
# ---------------------------------------------------------------------------


def add(a, b):
    """(a + b) mod p for canonical a, b (reference formula for any input)."""
    if isinstance(b, int):
        b = i64(b)
    s = a + b  # wraps mod 2^64
    s = s + _ult(s, a) * EPSILON  # wrapped => add back 2^64 - p
    return torch.where(_ge_p(s), s - _P, s)


def sub(a, b):
    """(a - b) mod p for canonical a, b."""
    if isinstance(b, int):
        b = i64(b)
    if isinstance(a, int):
        a = torch.full_like(b, i64(a))
    d = a - b  # wraps mod 2^64
    return d - _ult(a, b) * EPSILON  # wrapped => want +p, not +2^64


def neg(a):
    return torch.where(a == 0, 0, _P - a)


def _mul_wide(a, b):
    """Full 64x64 -> 128-bit product as an (hi, lo) pair of u64 patterns."""
    a_lo, a_hi = _halves(a)
    b_lo, b_hi = _halves(b)
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    mid = lh + hl
    mid_carry = _ult(mid, lh)  # contributes 2^64 -> 2^32 in hi
    lo = ll + (mid << 32)
    lo_carry = _ult(lo, ll)
    hi = hh + _shr32(mid) + (mid_carry * (1 << 32)) + lo_carry
    return hi, lo


def _reduce128(hi, lo):
    """hi * 2^64 + lo mod p, canonical, using 2^64 = 2^32 - 1 and
    2^96 = -1 (mod p)."""
    hi_hi = _shr32(hi)
    hi_lo = hi & _MASK32
    t0 = lo - hi_hi
    t0 = t0 - _ult(lo, hi_hi) * EPSILON
    t1 = hi_lo * EPSILON  # < 2^64
    t = t0 + t1
    t = t + _ult(t, t0) * EPSILON
    return torch.where(_ge_p(t), t - _P, t)


def mul(a, b):
    """(a * b) mod p; canonical output for any u64 inputs."""
    hi, lo = _mul_wide(a, b)
    return _reduce128(hi, lo)


def square(a):
    return mul(a, a)


def mul_const(a, c: int):
    """Multiply by a python-int constant (reduced mod p)."""
    return mul(a, c % P)


def exp_const(a, e: int):
    """a^e for a python-int exponent (square-and-multiply)."""
    result = torch.ones_like(a)
    base = a
    while e > 0:
        if e & 1:
            result = mul(result, base)
        e >>= 1
        if e:
            base = square(base)
    return result


def inv(a):
    """a^(p-2): multiplicative inverse (0 -> 0)."""
    return exp_const(a, P - 2)


_BINV_CHUNK = 1024


def _prefix_products(mat: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products along axis 1 of [rows, k], by doubling."""
    d = 1
    k = mat.shape[1]
    while d < k:
        mat = torch.cat([mat[:, :d], mul(mat[:, d:], mat[:, :-d])], dim=1)
        d *= 2
    return mat


def _batch_inv_flat(safe: torch.Tensor) -> torch.Tensor:
    m = safe.shape[0]
    if m <= 4 * _BINV_CHUNK:
        return inv(safe)
    k = _BINV_CHUNK
    pad = (-m) % k
    if pad:
        safe = torch.cat([safe, torch.ones(pad, dtype=safe.dtype, device=safe.device)])
    mat = safe.reshape(-1, k)
    incl = _prefix_products(mat)
    totals_inv = _batch_inv_flat(incl[:, -1].contiguous())
    ones = torch.ones_like(mat[:, :1])
    pre = torch.cat([ones, incl[:, :-1]], dim=1)
    incl_rev = _prefix_products(mat.flip(1)).flip(1)
    suf = torch.cat([incl_rev[:, 1:], ones], dim=1)
    out = mul(mul(pre, suf), totals_inv[:, None])
    return out.reshape(-1)[:m]


def batch_inv(x):
    """Elementwise inverse by chunked Montgomery batching (0 -> 0).

    Rows of 1024 elements get prefix/suffix products by log-depth doubling;
    the row totals are inverted recursively, ending in one Fermat chain.
    """
    shape = x.shape
    flat = x.reshape(-1)
    is_zero = flat == 0
    safe = torch.where(is_zero, 1, flat)
    out = _batch_inv_flat(safe)
    out = torch.where(is_zero, 0, out)
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# Host-side scalar mirror (python ints)
# ---------------------------------------------------------------------------


def h_add(a: int, b: int) -> int:
    return (a + b) % P


def h_sub(a: int, b: int) -> int:
    return (a - b) % P


def h_mul(a: int, b: int) -> int:
    return (a * b) % P


def h_inv(a: int) -> int:
    return pow(a, P - 2, P) if a else 0


def h_exp(a: int, e: int) -> int:
    return pow(a, e, P)


def primitive_root_of_unity(n_log: int) -> int:
    """Generator of the order-2^n_log subgroup (python int)."""
    assert 0 <= n_log <= TWO_ADICITY
    return pow(POWER_OF_TWO_GENERATOR, 1 << (TWO_ADICITY - n_log), P)


@functools.lru_cache(maxsize=None)
def two_adic_subgroup(n_log: int) -> np.ndarray:
    """All 2^n_log roots of unity, in generator-power order (numpy u64)."""
    return powers(primitive_root_of_unity(n_log), 1 << n_log)


def powers(base: int, n: int) -> np.ndarray:
    """[base^0, ..., base^(n-1)] mod p as numpy u64, by doubling."""
    out = np.ones(max(n, 1), dtype=object)
    m, cur = 1, base % P
    while m < n:
        k = min(m, n - m)
        out[m : m + k] = out[:k] * cur % P
        m += k
        cur = cur * cur % P
    return out[:n].astype(np.uint64)

