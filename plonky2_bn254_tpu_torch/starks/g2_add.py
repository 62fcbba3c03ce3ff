"""g2_add row semantics: unified Fq2 affine add/double.

Port of `plonky2_bn254_tpu/starks/g2_add.py`: the constraint structure of
g1_add over the Fq2 limb algebra (`fq2_alg`).  Generation is batched and
grouped to keep the number of tensor ops small: the four inverses it needs
(both components of b.x - a.x for the x-equality witness, and the norms of
b.x - a.x and 2 a.y for the two slopes) come from one batched inversion,
both slope candidates from one `f2_mul`, the five wide products from one
convolution and the four modulus-zero witnesses from one pass.
Evaluation is ring-generic.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import bigint, fq2_alg, modular, pol
from .air import eval_eq
from .layout import IS_MODULUS_ZERO_AUX_LAYOUT, Layout, MODULUS_ZERO_AUX_LAYOUT
from .limbs import N_LIMBS

G2_LEN = 4 * N_LIMBS  # 64

EXT_MODULUS_ZERO_AUX_LAYOUT = Layout(
    [("c0_aux", MODULUS_ZERO_AUX_LAYOUT), ("c1_aux", MODULUS_ZERO_AUX_LAYOUT)]
)
IS_EXT_MODULUS_ZERO_AUX_LAYOUT = Layout(
    [
        ("is_c0_zero", 1),
        ("is_c1_zero", 1),
        ("c0_aux", IS_MODULUS_ZERO_AUX_LAYOUT),
        ("c1_aux", IS_MODULUS_ZERO_AUX_LAYOUT),
    ]
)
G2_ADD_AUX_LAYOUT = Layout(
    [
        ("is_x_eq", 1),
        ("is_x_eq_aux", IS_EXT_MODULUS_ZERO_AUX_LAYOUT),
        ("is_x_eq_filter", 1),
        ("lambda", 2 * N_LIMBS),
        ("lambda_aux", EXT_MODULUS_ZERO_AUX_LAYOUT),
        ("x_aux", EXT_MODULUS_ZERO_AUX_LAYOUT),
        ("y_aux", EXT_MODULUS_ZERO_AUX_LAYOUT),
    ]
)
G2_ADD_AUX_LEN = G2_ADD_AUX_LAYOUT.width
assert G2_ADD_AUX_LEN == 708


class G2AddAux(NamedTuple):
    is_x_eq: torch.Tensor
    is_x_eq_aux: fq2_alg.IsExtModulusZeroAux
    is_x_eq_filter: torch.Tensor
    lam: tuple  # (c0, c1) [..., 16]
    lambda_aux: fq2_alg.ExtModulusZeroAux
    x_aux: fq2_alg.ExtModulusZeroAux
    y_aux: fq2_alg.ExtModulusZeroAux


def _select(cond, a, b):
    """Where cond == 1 take a, else b, through a witness tuple."""
    if isinstance(a, tuple):
        return type(a)(*(_select(cond, x, y) for x, y in zip(a, b)))
    c = cond.reshape(cond.shape + (1,) * (a.dim() - cond.dim()))
    return torch.where(c == 1, a, b)


def _add_low(wide, v):
    """wide[..., :16] += v for 31-coefficient polynomials."""
    return wide + F.pad(v, (0, wide.shape[-1] - N_LIMBS))


def generate_g2_add(ax, ay, bx, by):
    """Batched G2 unified add: [2, ..., 16] Fq2 coordinates (c0, c1 on the
    leading axis) -> (cx, cy [2, ..., 16], G2AddAux over [...]).

    The caller guarantees that no point at infinity arises and that
    x-equality implies a == b."""
    P = bigint.const_row(bigint.MOD_LIMBS_INT, ax.device)
    delta_x = bx - ax  # signed limbs
    delta_y = by - ay
    dx_res = modular.signed_residue(delta_x)
    dy_res = modular.signed_residue(delta_y)
    two_y = fq2_alg.f2_small(2, ay)
    denoms = torch.stack([dx_res, two_y], dim=1)  # [2, 2, ..., 16]
    invs = bigint.batch_inv_mod_p(torch.cat([dx_res, fq2_alg.f2_norm(denoms)]))
    is_x_eq, is_x_eq_aux = fq2_alg.generate_is_ext_modulus_zero(delta_x, dx_res, invs[:2])

    # both slopes: (b.y - a.y) / (b.x - a.x) and 3 a.x^2 / (2 a.y)
    three_x_sq = fq2_alg.f2_small(3, fq2_alg.f2_mul(ax, ax))
    lam_neq, lam_eq = fq2_alg.f2_mul(
        torch.stack([dy_res, three_x_sq], dim=1), fq2_alg.f2_conj_scale(denoms, invs[2:])
    ).unbind(1)
    lam = torch.where(is_x_eq[..., None] == 1, lam_eq, lam_neq)

    # c = (lambda^2 - a.x - b.x, lambda (a.x - c.x) - a.y)
    cx = bigint.reduce_small(fq2_alg.f2_mul(lam, lam) - ax - bx + 2 * P)
    cy = bigint.reduce_small(
        fq2_alg.f2_mul(lam, bigint.reduce_small(ax - cx + P)) - ay + P)

    # wide products: lambda dx, a.x^2, lambda a.y, lambda^2, lambda (c.x - a.x)
    w = fq2_alg.ext_mul_wide(torch.stack([lam, ax, lam, lam, lam], dim=1),
                             torch.stack([delta_x, ax, ay, lam, cx - ax], dim=1))
    diffs = torch.stack([
        _add_low(w[:, 0], -delta_y),  # chord: lambda dx - dy
        2 * w[:, 2] - 3 * w[:, 1],  # tangent: 2 lambda a.y - 3 a.x^2
        _add_low(w[:, 3], -(ax + bx + cx)),  # lambda^2 - (a.x + b.x + c.x)
        _add_low(w[:, 4], cy + ay),  # lambda (c.x - a.x) + c.y + a.y
    ], dim=1)
    mz = modular.generate_modulus_zero(diffs)  # over [2, 4, ...]

    def ext(j):
        return fq2_alg.ExtModulusZeroAux(modular.index_tree(mz, (0, j)),
                                         modular.index_tree(mz, (1, j)))

    aux = G2AddAux(
        is_x_eq=is_x_eq,
        is_x_eq_aux=is_x_eq_aux,
        is_x_eq_filter=is_x_eq,
        lam=(lam[0], lam[1]),
        lambda_aux=_select(is_x_eq, ext(1), ext(0)),
        x_aux=ext(2),
        y_aux=ext(3),
    )
    return cx, cy, aux


# ---------------------------------------------------------------------------
# Ring-generic evaluation
# ---------------------------------------------------------------------------


def _pair(view16x2):
    """32-value list -> (c0 list, c1 list)."""
    return view16x2[:N_LIMBS], view16x2[N_LIMBS:]


def _ext_sub(a, b):
    return (
        [a[0][i] - b[0][i] for i in range(len(a[0]))],
        [a[1][i] - b[1][i] for i in range(len(a[1]))],
    )


def _ext_add(a, b):
    return (
        [a[0][i] + b[0][i] for i in range(len(a[0]))],
        [a[1][i] + b[1][i] for i in range(len(a[1]))],
    )


def _ext_mul_wide_ring(a, b):
    m00 = pol.pol_mul_wide(a[0], b[0])
    m11 = pol.pol_mul_wide(a[1], b[1])
    m01 = pol.pol_mul_wide(a[0], b[1])
    m10 = pol.pol_mul_wide(a[1], b[0])
    return (
        [x - y for x, y in zip(m00, m11)],
        [x + y for x, y in zip(m01, m10)],
    )


def eval_g2_add(consumer, ring, filt, modulus, a, b, c, aux):
    """a/b/c: dicts {"x": 32 values, "y": 32 values} (c0 limbs then c1)."""
    ax, ay = _pair(a["x"]), _pair(a["y"])
    bx, by = _pair(b["x"]), _pair(b["y"])
    cx, cy = _pair(c["x"]), _pair(c["y"])

    delta_x = _ext_sub(bx, ax)
    fq2_alg.eval_is_ext_modulus_zero(
        consumer, ring, filt, modulus, delta_x, aux["is_x_eq"], aux["is_x_eq_aux"]
    )
    is_x_eq_filter = aux["is_x_eq_filter"]
    consumer.constraint(filt * aux["is_x_eq"] - is_x_eq_filter)
    is_not_eq_filter = filt - is_x_eq_filter

    lam = _pair(aux["lambda"])
    # chord branch
    lam_dx = _ext_mul_wide_ring(lam, delta_x)
    delta_y = _ext_sub(by, ay)
    diff = (
        pol.pol_sub(lam_dx[0], delta_y[0]),
        pol.pol_sub(lam_dx[1], delta_y[1]),
    )
    fq2_alg.eval_ext_modulus_zero(
        consumer, ring, is_not_eq_filter, modulus, diff, aux["lambda_aux"]
    )
    # tangent branch
    x_sq = _ext_mul_wide_ring(ax, ax)
    lam_y = _ext_mul_wide_ring(lam, ay)
    diff = (
        [p.scalar_mul(2) - q.scalar_mul(3) for p, q in zip(lam_y[0], x_sq[0])],
        [p.scalar_mul(2) - q.scalar_mul(3) for p, q in zip(lam_y[1], x_sq[1])],
    )
    fq2_alg.eval_ext_modulus_zero(
        consumer, ring, is_x_eq_filter, modulus, diff, aux["lambda_aux"]
    )
    # anti-infinity
    eval_eq(consumer, is_x_eq_filter, a["y"], b["y"])

    # x: lambda^2 - (a.x + b.x + c.x)
    sum_x = _ext_add(_ext_add(ax, bx), cx)
    lam_sq = _ext_mul_wide_ring(lam, lam)
    diff = (
        pol.pol_sub(lam_sq[0], sum_x[0]),
        pol.pol_sub(lam_sq[1], sum_x[1]),
    )
    fq2_alg.eval_ext_modulus_zero(consumer, ring, filt, modulus, diff, aux["x_aux"])

    # y: lambda*(c.x - a.x) + c.y + a.y
    cxax = _ext_sub(cx, ax)
    lam_cx = _ext_mul_wide_ring(lam, cxax)
    cyay = _ext_add(cy, ay)
    diff = (
        pol.pol_add(lam_cx[0], cyay[0]),
        pol.pol_add(lam_cx[1], cyay[1]),
    )
    fq2_alg.eval_ext_modulus_zero(consumer, ring, filt, modulus, diff, aux["y_aux"])
