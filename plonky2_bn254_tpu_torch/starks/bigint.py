"""Batched 256-bit modular arithmetic over BN254 p, on 16-bit limbs.

Port of `plonky2_bn254_tpu/starks/bigint.py`.  Inputs are `[..., n_limbs]`
int64 tensors; every function returns the same limbs as its JAX
counterpart.  Two things are done differently, to cut the number of tensor
ops (each op is one kernel launch on the card):

  * `carry_prop` is parallel over the limbs: three rounds of "keep the low
    16 bits, move the rest one limb up" bring every limb into [-1, 2^16],
    and two carry-lookahead passes (generate /
    propagate, resolved with a cumulative max) finish the carries.  The
    result is the value mod 2^(16 n_out) in canonical limbs, which is what
    the sequential scan computes.
  * Limb-polynomial products are one broadcast multiply and one skewed sum
    over anti-diagonals.

`mod_p` is Barrett reduction with mu = floor(2^512 / p) and two conditional
subtractions; `exact_div_p` is Hensel exact division mod 2^288; `inv_mod_p`
is Fermat over the constant bits of p - 2.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..bn254.params import P as BN254_P
from .limbs import LIMB_BITS, LIMB_MASK, N_LIMBS, h_int_to_limbs

MOD_LIMBS_INT = h_int_to_limbs(BN254_P, N_LIMBS)  # [16]
_MU_INT = (1 << 512) // BN254_P  # 259 bits -> 17 limbs
MU_LIMBS_INT = h_int_to_limbs(_MU_INT, 17)
_PINV_288 = pow(BN254_P, -1, 1 << 288)  # p^-1 mod 2^288 -> 18 limbs
PINV_LIMBS_INT = h_int_to_limbs(_PINV_288, 18)

_P_BITS = [(BN254_P - 2) >> i & 1 for i in range(254)]  # LSB-first bits of p-2


@functools.lru_cache(maxsize=None)
def _const_row(limbs_int: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(limbs_int, dtype=torch.int64, device=device)


def const_row(limbs_int, device) -> torch.Tensor:
    return _const_row(tuple(int(v) for v in limbs_int), torch.device(device))


def _fit(coeffs: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-extend or truncate the limb axis to n."""
    n_in = coeffs.shape[-1]
    if n_in < n:
        return F.pad(coeffs, (0, n - n_in))
    return coeffs[..., :n]


def _lookahead(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Carry into each limb from generate/propagate flags (0/1 int64):
    1 where some lower limb generates and every limb between propagates."""
    n = g.shape[-1]
    idx = torch.arange(n, device=g.device).expand(g.shape)
    last_stop = torch.where(p, -1, idx).cummax(dim=-1).values
    last_below = F.pad(last_stop[..., :-1], (1, 0), value=-1)
    return g.gather(-1, last_below.clamp(min=0)) & (last_below >= 0)


def carry_prop(coeffs: torch.Tensor, n_out: int) -> torch.Tensor:
    """Signed coefficient vector -> canonical limbs in [0, 2^16) of its value
    mod 2^(16 n_out); the input is zero-extended or truncated to n_out.

    Coefficients must satisfy |c| < 2^47 (this package's never exceed
    2^42: products of 16-bit limbs summed over <= 49 terms); three rounds
    then bring every limb into [-1, 2^16]."""
    x = _fit(coeffs, n_out)
    for _ in range(3):
        x = (x & LIMB_MASK) + F.pad((x >> LIMB_BITS)[..., :-1], (1, 0))
    neg = (x < 0).to(torch.int64)
    pos = x + neg  # [0, 2^16]
    a = (pos + _lookahead((pos == LIMB_MASK + 1).to(torch.int64), pos == LIMB_MASK)) & LIMB_MASK
    d = a - neg  # [-1, 2^16 - 1]
    return (d - _lookahead((d < 0).to(torch.int64), d == 0)) & LIMB_MASK


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., na] x [..., nb] -> [..., na+nb-1] coefficient product: the outer
    product, skewed so that anti-diagonals become columns, summed."""
    na, nb = a.shape[-1], b.shape[-1]
    m = a[..., :, None] * b[..., None, :]
    lead = m.shape[:-2]
    z = F.pad(m, (0, na)).reshape(lead + (na * (na + nb),))
    return z[..., : na * (na + nb - 1)].reshape(lead + (na, na + nb - 1)).sum(-2)


def _pol_mul_arrays(a: torch.Tensor, b_const: list) -> torch.Tensor:
    """[..., na] limb tensor times a constant limb list -> [..., na+nb-1]."""
    return _conv(a, const_row(b_const, a.device))


def _pol_mul_aa(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., na] x [..., nb] -> [..., na+nb-1] coefficient product."""
    return _conv(a, b)


def mul_full(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 16] x [..., 16] canonical limbs -> [..., 32] canonical limbs."""
    return carry_prop(_conv(a, b), 2 * N_LIMBS)


def _sub_p_if_ge(r: torch.Tensor) -> torch.Tensor:
    """r - p where r >= p, else r; canonical 18-limb values < 2^272."""
    t = carry_prop(r - const_row(MOD_LIMBS_INT + [0, 0], r.device), 18)
    ge = (t[..., 17:18] >> (LIMB_BITS - 1)) == 0  # nonnegative difference
    return torch.where(ge, t, r)


def mod_p(n: torch.Tensor) -> torch.Tensor:
    """[..., <=32] canonical limbs (value < 2^512) -> value mod p, 16 limbs."""
    n32 = carry_prop(n, 32) if n.shape[-1] < 32 else n
    # q_hat = floor(n * mu / 2^512): top 17 limbs of the 49-limb product
    q_hat = carry_prop(_pol_mul_arrays(n32, MU_LIMBS_INT), 49)[..., 32:49]
    # r = n - q_hat * p  (fits well under 2^272; computed mod 2^288)
    qp = _pol_mul_arrays(q_hat, MOD_LIMBS_INT)
    r = carry_prop(n32[..., :18] - qp[..., :18], 18)
    # 0 <= r < 3p: subtract p up to twice
    r = _sub_p_if_ge(_sub_p_if_ge(r))
    return r[..., :N_LIMBS]


def reduce_small(v: torch.Tensor) -> torch.Tensor:
    """Signed 16-limb coefficients of a value in [0, 8p) -> value mod p.

    Gives `mod_p(carry_prop(v, 32))` (the residue is unique) with three
    conditional subtractions (4p, 2p, p) instead of a Barrett pass; the
    Jacobian formulas' linear combinations all lie in [0, 8p)."""
    r = carry_prop(v, 17)
    for m in (4, 2, 1):
        t = carry_prop(r - const_row(h_int_to_limbs(m * BN254_P, 17), r.device), 17)
        r = torch.where((t[..., 16:17] >> (LIMB_BITS - 1)) == 0, t, r)
    return r[..., :N_LIMBS]


def mulmod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod p on [..., 16] canonical limb tensors."""
    return mod_p(mul_full(a, b))


def addmod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p on [..., 16] residues in [0, p)."""
    return reduce_small(a + b)


def submod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p on [..., 16] residues in [0, p)."""
    return reduce_small(a - b + const_row(MOD_LIMBS_INT, a.device))


def exact_div_p(input_coeffs: torch.Tensor):
    """Exact signed division by p of a 31-coefficient polynomial value.

    `input_coeffs[..., 31]` are signed int64 coefficients (|c| < 2^40) of a
    value that is an exact multiple of p.  Returns (is_quot_positive [...],
    quot_abs [..., 17]) as the reference's generate_modulus_zero derives them.
    """
    n_lo = carry_prop(input_coeffs, 18)  # n mod 2^288, two's complement
    q = carry_prop(_pol_mul_arrays(n_lo, PINV_LIMBS_INT)[..., :18], 18)
    is_neg = (q[..., 17:18] >> (LIMB_BITS - 1)) & 1  # |q| < 2^287
    flipped = torch.where(is_neg == 1, LIMB_MASK - q, q)
    flipped = torch.cat([flipped[..., :1] + is_neg, flipped[..., 1:]], dim=-1)
    q_abs = torch.where(is_neg == 1, carry_prop(flipped, 18), q)
    is_zero = (q_abs == 0).all(dim=-1)
    is_quot_positive = ((is_neg[..., 0] == 0) & ~is_zero).to(torch.int64)
    return is_quot_positive, q_abs[..., :17]


def inv_mod_p(a: torch.Tensor) -> torch.Tensor:
    """Fermat inverse a^(p-2) mod p on [..., 16] limbs (0 -> 0), batched over
    all leading axes: one squaring per exponent bit and one multiply per
    set bit."""
    result = None
    base = a
    last = max(i for i, b in enumerate(_P_BITS) if b)
    for i, bit in enumerate(_P_BITS[: last + 1]):
        if bit:
            result = base if result is None else mulmod(result, base)
        if i < last:
            base = mulmod(base, base)
    a_is_zero = (a == 0).all(dim=-1, keepdim=True)
    return torch.where(a_is_zero, 0, result)


_BINV_CHUNK = 32


def _prefix_mulmod(mat: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products along axis 1 of [rows, k, 16], by doubling."""
    d = 1
    while d < mat.shape[1]:
        mat = torch.cat([mat[:, :d], mulmod(mat[:, d:], mat[:, :-d])], dim=1)
        d *= 2
    return mat


def batch_inv_mod_p(a: torch.Tensor) -> torch.Tensor:
    """Montgomery-batched modular inverse over all leading axes (0 -> 0).

    Rows of 32 elements get prefix/suffix products by log-depth doubling;
    one Fermat chain inverts the row totals.  The inverse is unique, so the
    values equal the reference's."""
    shape = a.shape
    flat = a.reshape(-1, N_LIMBS)
    m = flat.shape[0]
    is_zero = (flat == 0).all(dim=-1, keepdim=True)
    one = torch.zeros_like(flat[:1])
    one[:, 0] = 1
    safe = torch.where(is_zero, one, flat)
    pad = (-m) % _BINV_CHUNK
    if pad:
        safe = torch.cat([safe, one.expand(pad, N_LIMBS)])
    mat = safe.reshape(-1, _BINV_CHUNK, N_LIMBS)
    incl = _prefix_mulmod(mat)
    totals_inv = inv_mod_p(incl[:, -1])
    ones = one.expand(mat.shape[0], 1, N_LIMBS)
    pre = torch.cat([ones, incl[:, :-1]], dim=1)
    suf = torch.cat([_prefix_mulmod(mat.flip(1)).flip(1)[:, 1:], ones], dim=1)
    out = mulmod(mulmod(pre, suf), totals_inv[:, None]).reshape(-1, N_LIMBS)[:m]
    return torch.where(is_zero, 0, out).reshape(shape)


# ---------------------------------------------------------------------------
# Host helpers for tests
# ---------------------------------------------------------------------------


def h_mod_p(x: int) -> int:
    return x % BN254_P
