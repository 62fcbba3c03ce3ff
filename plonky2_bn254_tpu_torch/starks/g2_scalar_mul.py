"""G2ScalarMulStark: batched s*x + offset over the BN254 twist (Fq2).

Port of `plonky2_bn254_tpu/starks/g2_scalar_mul.py`: `scalar_mul`'s machine
over G2, whose coordinates are [2, n, 16] Fq2 limb tensors (c0, c1 on the
leading axis), with the Jacobian algebra of `fq2_alg` and the `g2_add`
gadget; row width 1295.
"""

from __future__ import annotations

from functools import partial

from ..bn254 import oracle
from . import fq2_alg, g2_add, rows, scalar_mul
from .limbs import N_LIMBS


def _aux_cols(aux: g2_add.G2AddAux):
    def mz(m):
        return [m.is_quot_positive[..., None], m.quot_abs, m.aux_lo, m.aux_hi]

    def imz(m):
        return [m.inv] + mz(m.modulus_zero_aux)

    def ext(e):
        return mz(e.c0_aux) + mz(e.c1_aux)

    return (
        [
            aux.is_x_eq[..., None],
            aux.is_x_eq_aux.is_c0_zero[..., None],
            aux.is_x_eq_aux.is_c1_zero[..., None],
        ]
        + imz(aux.is_x_eq_aux.c0_aux)
        + imz(aux.is_x_eq_aux.c1_aux)
        + [aux.is_x_eq_filter[..., None], aux.lam[0], aux.lam[1]]
        + ext(aux.lambda_aux)
        + ext(aux.x_aux)
        + ext(aux.y_aux)
    )


def _blocks(x, y):
    """[2, ...] Fq2 coordinates -> the point's four 16-limb column blocks."""
    return [x[0], x[1], y[0], y[1]]


def _coord(cols):
    """[n, 32] columns (c0 limbs, c1 limbs) -> [2, n, 16]."""
    return cols.reshape(-1, 2, N_LIMBS).transpose(0, 1)


def _ints(p):
    return [p[0][0], p[0][1], p[1][0], p[1][1]]


CURVE = scalar_mul.Curve(
    degree=2, double=fq2_alg.jac_double, mixed_add=fq2_alg.jac_mixed_add,
    to_affine=fq2_alg.jac_to_affine, generate_add=g2_add.generate_g2_add,
    eval_add=g2_add.eval_g2_add, add_aux=g2_add.G2_ADD_AUX_LAYOUT, aux_cols=_aux_cols,
    blocks=_blocks, coord=_coord, ints=_ints, mul=oracle.g2_mul, add=oracle.g2_add,
)

G2_PERIOD = rows.PERIOD  # 512
G2_LEN = g2_add.G2_LEN  # 64

LAYOUT = CURVE.layout
assert LAYOUT.width == 1295
RANGE_CHECK_COLS = CURVE.range_check_cols
FREQ_COL = LAYOUT.col("frequency")
RANGE_COUNTER_COL = LAYOUT.col("range_counter")

generate_trace_core = partial(scalar_mul.generate_trace_core, CURVE)
add_range_checks = partial(scalar_mul.add_range_checks, CURVE)
generate_trace = partial(scalar_mul.generate_trace, CURVE)
eval_g2_scalar_mul = partial(scalar_mul.eval_scalar_mul, CURVE)
lookups = partial(scalar_mul.lookups, CURVE)
ctls = partial(scalar_mul.ctls, CURVE)
generate_ctl_values = partial(scalar_mul.generate_ctl_values, CURVE)
