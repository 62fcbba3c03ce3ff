"""Modular-constraint primitives: modulus_zero and is_modulus_zero.

Port of `plonky2_bn254_tpu/starks/modular.py`: batched witness generation
(generate_*) over `[..., .]` int64 limb tensors, and one ring-generic
constraint evaluation (eval_*) for the prover (Goldilocks tensors on the
LDE coset) and the verifier (extension scalars at zeta).

Aux layouts:
  ModulusZeroAux   = is_quot_positive(1) | quot_abs(17) | aux_lo(31) | aux_hi(31)   -> 80
  IsModulusZeroAux = inv(16) | ModulusZeroAux(80)                                   -> 96
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..bn254.params import P as BN254_P
from ..field import goldilocks as gl
from . import bigint, pol
from .limbs import LIMB_BITS, LIMB_MASK, N_LIMBS, h_int_to_limbs

AUX_COEFF_ABS_MAX = 1 << 29
MODULUS_AUX_ZERO_LEN = 5 * N_LIMBS  # 80
IS_MODULUS_AUX_ZERO_LEN = N_LIMBS + MODULUS_AUX_ZERO_LEN  # 96

MOD_LIMBS = bigint.MOD_LIMBS_INT
# p << 32 as 32 limbs: added to signed 16-limb values to clear their sign
OFFSET_LIMBS = h_int_to_limbs(BN254_P << 32, 20) + [0] * 12


class ModulusZeroAux(NamedTuple):
    is_quot_positive: torch.Tensor  # [...]
    quot_abs: torch.Tensor  # [..., 17]
    aux_lo: torch.Tensor  # [..., 31]
    aux_hi: torch.Tensor  # [..., 31]


class IsModulusZeroAux(NamedTuple):
    inv: torch.Tensor  # [..., 16]
    modulus_zero_aux: ModulusZeroAux


def index_tree(tree, i):
    """Entry i along the leading axes of every tensor in a (nested) witness
    tuple, e.g. one half of a witness computed over stacked [2, ...] inputs."""
    if isinstance(tree, tuple):
        items = [index_tree(t, i) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree[i]


def generate_modulus_zero(input_coeffs: torch.Tensor) -> ModulusZeroAux:
    """Witness that the value of `input_coeffs[..., 31]` is divisible by p."""
    is_quot_positive, quot_abs = bigint.exact_div_p(input_coeffs)
    # signed quot limbs: sign * abs; sign = -1 unless strictly positive
    quot_signed = quot_abs * (2 * is_quot_positive - 1)[..., None]
    # constr_poly[32] = input (zero-extended) - quot(x) * m(x)
    prod = F.pad(bigint._pol_mul_arrays(quot_signed, MOD_LIMBS), (0, 2 * N_LIMBS - 32))
    constr = F.pad(input_coeffs, (0, 1)) - prod
    # aux_limbs = constr / (x - 2^16), exact
    q = pol.pol_remove_root_2exp([constr[..., i] for i in range(2 * N_LIMBS)], LIMB_BITS)
    aux = torch.stack(q[: 2 * N_LIMBS - 1], dim=-1) + AUX_COEFF_ABS_MAX
    return ModulusZeroAux(is_quot_positive, quot_abs, aux & LIMB_MASK, aux >> LIMB_BITS)


def eval_modulus_zero(consumer, ring, filt, modulus, input_poly, aux):
    """Ring-generic constraint: value(input_poly) ≡ 0 (mod p), degree <= 3.

    `modulus`: 16 ring values; `input_poly`: 31 ring values; `aux`: dict of
    ring values (is_quot_positive, quot_abs 17, aux_lo/aux_hi 31 each).
    GL-ring consumers with alpha power tables take a stacked tensor path
    (same constraint values, same order).
    """
    from .air import GL

    if isinstance(filt, GL) and getattr(consumer, "alpha_pows", None) is not None:
        return _eval_modulus_zero_stacked(consumer, filt, input_poly, aux)
    iqp = aux["is_quot_positive"]
    quot_abs = aux["quot_abs"]
    aux_lo = aux["aux_lo"]
    aux_hi = aux["aux_hi"]
    one = ring.one()

    consumer.constraint(filt * (iqp * iqp - iqp))
    quot_sign = iqp + iqp - one
    quot = [quot_sign * l for l in quot_abs]
    constr = pol.pol_mul_wide(quot, modulus)  # 32
    base = ring.const(1 << LIMB_BITS)
    offset = ring.const(AUX_COEFF_ABS_MAX)
    aux_poly = [aux_lo[i] - offset + base * aux_hi[i] for i in range(2 * N_LIMBS - 1)]
    aux_poly.append(ring.zero())
    constr = pol.pol_add(constr, pol.pol_adjoin_root(aux_poly, base))
    constr = pol.pol_sub(constr, input_poly)
    consumer.constraint_many([filt * c for c in constr])


def _eval_modulus_zero_stacked(consumer, filt, input_poly, aux):
    """Stacked mirror of the generic path (GL ring only)."""
    from .air import GL

    iqp = aux["is_quot_positive"].v
    quot = torch.stack([v.v for v in aux["quot_abs"]])  # [17, C]
    lo = torch.stack([v.v for v in aux["aux_lo"]])  # [31, C]
    hi = torch.stack([v.v for v in aux["aux_hi"]])  # [31, C]
    fv = filt.v

    consumer.constraint(GL(gl.mul(fv, gl.sub(gl.mul(iqp, iqp), iqp))))
    quot_s = gl.mul(quot, gl.sub(gl.add(iqp, iqp), 1)[None])
    # constr = q(x) * m(x): convolution with the 16 constant modulus limbs
    prod = torch.zeros((2 * N_LIMBS,) + iqp.shape, dtype=torch.int64, device=iqp.device)
    for j, m_j in enumerate(MOD_LIMBS):
        if m_j:
            prod[j : j + 17] = gl.add(prod[j : j + 17], gl.mul_const(quot_s, int(m_j)))
    # aux_poly s(x) and (x - beta) * s(x)
    aux_p = gl.add(gl.sub(lo, AUX_COEFF_ABS_MAX), gl.mul_const(hi, 1 << LIMB_BITS))
    b_aux = gl.mul_const(aux_p, 1 << LIMB_BITS)
    adjoin = torch.cat(
        [gl.neg(b_aux[:1]), gl.sub(aux_p[: 2 * N_LIMBS - 2], b_aux[1:]),
         aux_p[2 * N_LIMBS - 2 :]],
        dim=0,
    )  # [32, C]
    constr = gl.add(prod, adjoin)
    inp = torch.stack([v.v for v in input_poly])  # [31, C]
    constr = torch.cat(
        [gl.sub(constr[: 2 * N_LIMBS - 1], inp), constr[2 * N_LIMBS - 1 :]], dim=0
    )
    consumer.constraint_many_arr(gl.mul(fv[None], constr))


def signed_residue(limbs: torch.Tensor) -> torch.Tensor:
    """Signed 16-limb coefficients (|c| < 2^16) -> canonical value mod p."""
    shifted = F.pad(limbs, (0, 32 - limbs.shape[-1])) + bigint.const_row(OFFSET_LIMBS,
                                                                         limbs.device)
    return bigint.mod_p(bigint.carry_prop(shifted, 32))


def generate_is_modulus_zero(input_limbs: torch.Tensor, residue=None, inv=None):
    """(is_zero, IsModulusZeroAux) for a signed 16-limb value: inv = (input
    mod p)^-1 (0 if zero) and the modulus_zero proof of
    input * inv - 1 + is_zero ≡ 0 (mod p).  A caller that already holds
    the residue and its inverse passes them in."""
    if residue is None:
        residue = signed_residue(input_limbs)
    if inv is None:
        inv = bigint.batch_inv_mod_p(residue)
    is_zero = (residue == 0).all(dim=-1).to(torch.int64)
    diff = bigint._pol_mul_aa(input_limbs, inv)
    diff = torch.cat([diff[..., :1] + (is_zero - 1)[..., None], diff[..., 1:]], dim=-1)
    return is_zero, IsModulusZeroAux(inv, generate_modulus_zero(diff))


def eval_is_modulus_zero(consumer, ring, filt, modulus, input_limbs, is_zero, aux):
    """Ring-generic mirror of eval_is_modulus_zero."""
    from .air import GL

    diff = pol.pol_mul_wide(input_limbs, aux["inv"])  # 31
    diff[0] = diff[0] + is_zero - ring.one()
    eval_modulus_zero(consumer, ring, filt, modulus, diff, aux["modulus_zero_aux"])
    if isinstance(filt, GL) and getattr(consumer, "alpha_pows", None) is not None:
        inp = torch.stack([v.v for v in input_limbs])
        consumer.constraint_many_arr(gl.mul(gl.mul(filt.v, is_zero.v)[None], inp))
    else:
        consumer.constraint_many([filt * (is_zero * limb) for limb in input_limbs])
