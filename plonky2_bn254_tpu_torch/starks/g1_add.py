"""g1_add row semantics: unified affine add/double with an x-equality branch.

Port of `plonky2_bn254_tpu/starks/g1_add.py`.  Generation is batched (both
lambda branches computed and selected per element); evaluation is
ring-generic:

  * is_x_eq witnessed by is_modulus_zero(b.x - a.x);
  * chord slope (x unequal) and tangent slope (x equal) share one lambda
    column + one lambda_aux, gated by is_not_eq_filter / is_x_eq_filter;
  * a.y == b.y forced when x equal (anti-infinity guard);
  * c.x from lambda^2 - a.x - b.x; c.y from lambda(a.x - c.x) - a.y.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import bigint, modular, pol
from .air import eval_eq
from .limbs import N_LIMBS

G1_LEN = 2 * N_LIMBS  # 32
G1_ADD_AUX_LEN = 1 + modular.IS_MODULUS_AUX_ZERO_LEN + 1 + N_LIMBS + 3 * modular.MODULUS_AUX_ZERO_LEN  # 354


class G1AddAux(NamedTuple):
    is_x_eq: torch.Tensor
    is_x_eq_aux: modular.IsModulusZeroAux
    is_x_eq_filter: torch.Tensor
    lam: torch.Tensor  # [..., 16]
    lambda_aux: modular.ModulusZeroAux
    x_aux: modular.ModulusZeroAux
    y_aux: modular.ModulusZeroAux



def _select_aux(cond, a: modular.ModulusZeroAux, b: modular.ModulusZeroAux):
    c1 = cond[..., None] == 1
    return modular.ModulusZeroAux(
        torch.where(cond == 1, a.is_quot_positive, b.is_quot_positive),
        torch.where(c1, a.quot_abs, b.quot_abs),
        torch.where(c1, a.aux_lo, b.aux_lo),
        torch.where(c1, a.aux_hi, b.aux_hi),
    )


def _add_last(diff: torch.Tensor, term: torch.Tensor) -> torch.Tensor:
    """diff[..., :16] += term for a 31-coefficient polynomial."""
    return diff + F.pad(term, (0, diff.shape[-1] - N_LIMBS))


def generate_g1_add(ax, ay, bx, by):
    """Batched unified add: four [..., 16] limb tensors -> (cx, cy, G1AddAux).

    Caller guarantees no point at infinity arises and that x-equality
    implies a == b.  The two inverses (of b.x - a.x for the chord slope and
    the is_x_eq witness, and of 2 a.y for the tangent slope) share one
    Fermat chain.
    """
    delta_x = bx - ax  # signed coefficients
    dx_res = modular.signed_residue(delta_x)
    dy_res = modular.signed_residue(by - ay)
    two_y = bigint.reduce_small(2 * ay)
    invs = bigint.batch_inv_mod_p(torch.stack([dx_res, two_y]))
    dx_inv, two_y_inv = invs[0], invs[1]
    is_x_eq, is_x_eq_aux = modular.generate_is_modulus_zero(delta_x, dx_res, dx_inv)

    # both lambda branches
    lam_neq = bigint.mulmod(dy_res, dx_inv)
    x_sq = bigint.mulmod(ax, ax)
    three_x_sq = bigint.reduce_small(3 * x_sq)
    lam_eq = bigint.mulmod(three_x_sq, two_y_inv)
    lam = torch.where(is_x_eq[..., None] == 1, lam_eq, lam_neq)

    # c = (lambda^2 - a.x - b.x, lambda(a.x - c.x) - a.y)
    lam_sq = bigint.mulmod(lam, lam)
    cx = modular.signed_residue(lam_sq - ax - bx)
    cy = modular.signed_residue(bigint.mulmod(lam, modular.signed_residue(ax - cx)) - ay)

    # lambda_aux (branch-selected)
    aux_neq = modular.generate_modulus_zero(
        _add_last(bigint._pol_mul_aa(lam, delta_x), -(by - ay))
    )
    diff_eq = 2 * bigint._pol_mul_aa(lam, ay) - 3 * bigint._pol_mul_aa(ax, ax)
    aux_eq = modular.generate_modulus_zero(diff_eq)
    lambda_aux = _select_aux(is_x_eq, aux_eq, aux_neq)

    # x_aux: lambda^2 - (a.x + b.x + c.x)
    x_aux = modular.generate_modulus_zero(
        _add_last(bigint._pol_mul_aa(lam, lam), -(ax + bx + cx))
    )
    # y_aux: lambda*(c.x - a.x) + c.y + a.y
    y_aux = modular.generate_modulus_zero(
        _add_last(bigint._pol_mul_aa(lam, cx - ax), cy + ay)
    )

    aux = G1AddAux(
        is_x_eq=is_x_eq,
        is_x_eq_aux=is_x_eq_aux,
        is_x_eq_filter=is_x_eq,
        lam=lam,
        lambda_aux=lambda_aux,
        x_aux=x_aux,
        y_aux=y_aux,
    )
    return cx, cy, aux


def eval_g1_add(consumer, ring, filt, modulus, a, b, c, aux):
    """Ring-generic mirror of eval_g1_add.

    `a`,`b`,`c`: dicts {"x": [16 values], "y": [16 values]}; `aux`: nested
    dict view of G1_ADD_AUX_LAYOUT.
    """
    delta_x = [b["x"][i] - a["x"][i] for i in range(N_LIMBS)]
    modular.eval_is_modulus_zero(
        consumer, ring, filt, modulus, delta_x, aux["is_x_eq"], aux["is_x_eq_aux"]
    )
    is_x_eq_filter = aux["is_x_eq_filter"]
    consumer.constraint(filt * aux["is_x_eq"] - is_x_eq_filter)
    is_not_eq_filter = filt - is_x_eq_filter

    lam = aux["lambda"]
    # chord branch: lambda*(b.x - a.x) - (b.y - a.y) ≡ 0
    lambda_delta_x = pol.pol_mul_wide(lam, delta_x)
    delta_y = [b["y"][i] - a["y"][i] for i in range(N_LIMBS)]
    diff = pol.pol_sub(lambda_delta_x, delta_y)
    modular.eval_modulus_zero(
        consumer, ring, is_not_eq_filter, modulus, diff, aux["lambda_aux"]
    )
    # tangent branch: 2*a.y*lambda - 3*a.x^2 ≡ 0
    x_sq = pol.pol_mul_wide(a["x"], a["x"])
    three_x_sq = pol.pol_mul_scalar(x_sq, 3)
    lambda_y = pol.pol_mul_wide(lam, a["y"])
    two_lambda_y = pol.pol_mul_scalar(lambda_y, 2)
    diff = [p - q for p, q in zip(two_lambda_y, three_x_sq)]
    modular.eval_modulus_zero(
        consumer, ring, is_x_eq_filter, modulus, diff, aux["lambda_aux"]
    )
    # anti-infinity: x equal forces y equal
    eval_eq(consumer, is_x_eq_filter, a["y"], b["y"])

    # x: lambda^2 - (a.x + b.x + c.x) ≡ 0
    sum_x = [a["x"][i] + b["x"][i] + c["x"][i] for i in range(N_LIMBS)]
    lambda_sq = pol.pol_mul_wide(lam, lam)
    diff = pol.pol_sub(lambda_sq, sum_x)
    modular.eval_modulus_zero(consumer, ring, filt, modulus, diff, aux["x_aux"])

    # y: lambda*(c.x - a.x) + c.y + a.y ≡ 0
    c_x_sub_a_x = [c["x"][i] - a["x"][i] for i in range(N_LIMBS)]
    lambda_cx = pol.pol_mul_wide(lam, c_x_sub_a_x)
    c_y_a_y = [c["y"][i] + a["y"][i] for i in range(N_LIMBS)]
    diff = pol.pol_add(lambda_cx, c_y_a_y)
    modular.eval_modulus_zero(consumer, ring, filt, modulus, diff, aux["y_aux"])
