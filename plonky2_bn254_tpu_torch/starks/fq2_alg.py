"""Batched Fq2 limb algebra: the quadratic-extension layer for G2.

Port of `plonky2_bn254_tpu/starks/fq2_alg.py`, with u^2 = -1:

  (a0 + a1 u)(b0 + b1 u) = (a0 b0 - a1 b1) + (a0 b1 + a1 b0) u

An Fq2 batch is ONE int64 tensor `[2, ..., 16]`: c0 and c1 stacked on the
leading axis (the JAX package passes (c0, c1) pairs), so that each step
works on both halves in one tensor op.  To cut the number of ops (each one
a kernel launch on the card) the witness arithmetic is grouped:

  * `f2_mul` forms the four limb products in one convolution over
    `[4, ..., 16]` operands, combines them into the two signed coefficient
    vectors, and reduces both with one Barrett pass (`mod_p`): one
    reduction where the JAX package makes four `mulmod`s and two
    add/sub reductions;
  * the Jacobian formulas stack independent products into one `f2_mul`
    (`_muls`) and independent linear combinations into one `reduce_small`
    (`_lins`), each combination written directly from the values it needs
    and shifted by a multiple of p into [0, 8p).

Every value is the unique residue mod p, so the results equal the JAX
package's limb for limb.  Wide products (`ext_mul_wide`) stay unreduced
signed coefficients, as the modulus-zero witnesses need.

Aux layouts (identical to the reference):
  ExtModulusZeroAux   = c0_aux(80) | c1_aux(80)             -> 160
  IsExtModulusZeroAux = is_c0_zero | is_c1_zero | 2 x 96    -> 194
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..bn254.params import P as BN254_P
from . import bigint, modular
from .limbs import N_LIMBS, h_int_to_limbs

EXT_MODULUS_AUX_ZERO_LEN = 2 * modular.MODULUS_AUX_ZERO_LEN  # 160
IS_EXT_MODULUS_AUX_ZERO_LEN = 2 + 2 * modular.IS_MODULUS_AUX_ZERO_LEN  # 194

# p^2 on the c0 coefficients: a0 b0 - a1 b1 + p^2 lies in (0, 2 p^2) < 2^512
_WIDE_OFFSET = [h_int_to_limbs(BN254_P * BN254_P, 2 * N_LIMBS), [0] * (2 * N_LIMBS)]


def _p(t: torch.Tensor) -> torch.Tensor:
    return bigint.const_row(bigint.MOD_LIMBS_INT, t.device)


# ---------------------------------------------------------------------------
# Canonical (mod-p) Fq2 arithmetic on [2, ..., 16] residues
# ---------------------------------------------------------------------------


def f2_add(a, b):
    return bigint.addmod(a, b)


def f2_sub(a, b):
    return bigint.submod(a, b)


def f2_small(k: int, a):
    """k a mod p for a small constant 0 <= k <= 8."""
    assert 0 <= k <= 8, k
    return bigint.reduce_small(k * a)


def ext_mul_wide(a, b):
    """[2, ..., 16] x [2, ..., 16] -> [2, ..., 31] signed coefficients of
    (a0 b0 - a1 b1, a0 b1 + a1 b0), one convolution for the four products."""
    m = bigint._conv(torch.cat([a, a]), torch.cat([b, b.flip(0)]))
    return torch.stack([m[0] - m[1], m[2] + m[3]])


def f2_mul(a, b):
    """a b mod p on [2, ..., 16] residues (operands broadcast)."""
    a, b = torch.broadcast_tensors(a, b)
    w = F.pad(ext_mul_wide(a, b), (0, 1))
    off = torch.tensor(_WIDE_OFFSET, dtype=torch.int64, device=w.device)
    w = w + off.view((2,) + (1,) * (w.dim() - 2) + (2 * N_LIMBS,))
    return bigint.mod_p(bigint.carry_prop(w, 2 * N_LIMBS))


def f2_norm(a):
    """a0^2 + a1^2 mod p: [2, ..., 16] -> [..., 16]."""
    m = bigint._conv(a, a)
    return bigint.mod_p(bigint.carry_prop(m[0] + m[1], 2 * N_LIMBS))


def f2_conj_scale(a, s):
    """(a0 s, -a1 s) mod p: the inverse of a when s is 1 / norm(a)."""
    prod = bigint.mulmod(a, s[None])
    return torch.stack([prod[0], bigint.reduce_small(_p(a) - prod[1])])


def f2_inv(a):
    """(a0 - a1 u) / (a0^2 + a1^2); 0 -> 0 (Fermat convention).  One
    batched inversion covers every element of the batch."""
    return f2_conj_scale(a, bigint.batch_inv_mod_p(f2_norm(a)))


def _muls(*pairs):
    """Independent Fq2 products, stacked into one `f2_mul`."""
    a = torch.stack([x for x, _ in pairs], dim=1)
    b = torch.stack([y for _, y in pairs], dim=1)
    return f2_mul(a, b).unbind(1)


def _lins(*vals):
    """Independent linear combinations (signed limbs of values in [0, 8p))
    reduced to residues by one `reduce_small`."""
    return bigint.reduce_small(torch.stack(vals, dim=1)).unbind(1)


# ---------------------------------------------------------------------------
# Modulus-zero witnesses over Fq2
# ---------------------------------------------------------------------------


class ExtModulusZeroAux(NamedTuple):
    c0_aux: modular.ModulusZeroAux
    c1_aux: modular.ModulusZeroAux


class IsExtModulusZeroAux(NamedTuple):
    is_c0_zero: torch.Tensor
    is_c1_zero: torch.Tensor
    c0_aux: modular.IsModulusZeroAux
    c1_aux: modular.IsModulusZeroAux


def generate_ext_modulus_zero(input_wide) -> ExtModulusZeroAux:
    """[2, ..., 31] signed coefficients -> both components' witnesses, from
    one generate_modulus_zero over the stacked pair."""
    aux = modular.generate_modulus_zero(input_wide)
    return ExtModulusZeroAux(modular.index_tree(aux, 0), modular.index_tree(aux, 1))


def eval_ext_modulus_zero(consumer, ring, filt, modulus, input_wide, aux):
    modular.eval_modulus_zero(
        consumer, ring, filt, modulus, input_wide[0], aux["c0_aux"]
    )
    modular.eval_modulus_zero(
        consumer, ring, filt, modulus, input_wide[1], aux["c1_aux"]
    )


def generate_is_ext_modulus_zero(input_pair, residue=None, inv=None):
    """(is_zero, IsExtModulusZeroAux) for a signed [2, ..., 16] value; a
    caller that holds the components' residues and inverses passes them."""
    is_zero, aux = modular.generate_is_modulus_zero(input_pair, residue, inv)
    return is_zero[0] * is_zero[1], IsExtModulusZeroAux(
        is_zero[0], is_zero[1], modular.index_tree(aux, 0), modular.index_tree(aux, 1))


def eval_is_ext_modulus_zero(consumer, ring, filt, modulus, input_pair, is_zero, aux):
    consumer.constraint(filt * (aux["is_c0_zero"] * aux["is_c1_zero"] - is_zero))
    modular.eval_is_modulus_zero(
        consumer, ring, filt, modulus, input_pair[0], aux["is_c0_zero"], aux["c0_aux"]
    )
    modular.eval_is_modulus_zero(
        consumer, ring, filt, modulus, input_pair[1], aux["is_c1_zero"], aux["c1_aux"]
    )


# ---------------------------------------------------------------------------
# Jacobian arithmetic over Fq2 (G2 trace chains)
# ---------------------------------------------------------------------------


def jac_double(X, Y, Z):
    """dbl-2009-l over Fq2 (curve a = 0): three stacked products, four
    stacked reductions."""
    P = _p(X)
    A, B, YZ = _muls((X, X), (Y, Y), (Y, Z))
    E, XB, Z3 = _lins(3 * A, X + B, 2 * YZ)
    C, D0, F_ = _muls((B, B), (XB, XB), (E, E))
    D, C8 = _lins(2 * (D0 - A - C) + 4 * P, 8 * C)
    X3, DX3 = _lins(F_ - 2 * D + 2 * P, 3 * D - F_ + P)  # X3 = F - 2D, DX3 = D - X3
    (EDX,) = _muls((E, DX3))
    (Y3,) = _lins(EDX - C8 + P)
    return X3, Y3, Z3


def jac_mixed_add(X1, Y1, Z1, x2, y2):
    """madd-2007-bl over Fq2; the points distinct, no infinity: five
    stacked products, four stacked reductions."""
    P = _p(X1)
    Z1Z1, T = _muls((Z1, Z1), (y2, Z1))
    U2, S2 = _muls((x2, Z1Z1), (T, Z1Z1))
    H, r, ZH = _lins(U2 - X1 + P, 2 * (S2 - Y1) + 2 * P, Z1 + U2 - X1 + P)
    HH, r2, ZH2 = _muls((H, H), (r, r), (ZH, ZH))
    I, Z3 = _lins(4 * HH, ZH2 - Z1Z1 - HH + 2 * P)
    J, V = _muls((H, I), (X1, I))
    X3, VX3 = _lins(r2 - J - 2 * V + 3 * P, 3 * V + J - r2 + P)  # VX3 = V - X3
    rVX, Y1J = _muls((r, VX3), (Y1, J))
    (Y3,) = _lins(rVX - 2 * Y1J + 2 * P)
    return X3, Y3, Z3


def jac_to_affine(X, Y, Z):
    """Affine (x, y) of Jacobian points; one batched inversion over all."""
    zi = f2_inv(Z)
    (z2,) = _muls((zi, zi))
    z3, x = _muls((z2, zi), (X, z2))
    (y,) = _muls((Y, z3))
    return x, y
