"""G1ScalarMulStark: batched s*x + offset (BN254 G1) STARK machine.

Port of `plonky2_bn254_tpu/starks/g1_scalar_mul.py`: `scalar_mul`'s machine
over G1, whose coordinates are [n, 16] Fq limb tensors, with the Jacobian
algebra of `jacobian` and the `g1_add` gadget; row width 781.
"""

from __future__ import annotations

from functools import partial

from ..bn254 import oracle
from . import g1_add, jacobian, rows, scalar_mul
from .layout import G1_ADD_AUX_LAYOUT


def _aux_cols(aux: g1_add.G1AddAux):
    return [
        aux.is_x_eq[..., None],
        aux.is_x_eq_aux.inv,
        aux.is_x_eq_aux.modulus_zero_aux.is_quot_positive[..., None],
        aux.is_x_eq_aux.modulus_zero_aux.quot_abs,
        aux.is_x_eq_aux.modulus_zero_aux.aux_lo,
        aux.is_x_eq_aux.modulus_zero_aux.aux_hi,
        aux.is_x_eq_filter[..., None],
        aux.lam,
    ] + [
        arr
        for mz in (aux.lambda_aux, aux.x_aux, aux.y_aux)
        for arr in (mz.is_quot_positive[..., None], mz.quot_abs, mz.aux_lo, mz.aux_hi)
    ]


def _blocks(x, y):
    return [x, y]


def _coord(cols):
    return cols


CURVE = scalar_mul.Curve(
    degree=1, double=jacobian.double, mixed_add=jacobian.mixed_add,
    to_affine=jacobian.to_affine, generate_add=g1_add.generate_g1_add,
    eval_add=g1_add.eval_g1_add, add_aux=G1_ADD_AUX_LAYOUT, aux_cols=_aux_cols,
    blocks=_blocks, coord=_coord, ints=list, mul=oracle.g1_mul, add=oracle.g1_add,
)

G1_PERIOD = rows.PERIOD  # 512
G1_LEN = g1_add.G1_LEN  # 32

LAYOUT = CURVE.layout
assert LAYOUT.width == 781
RANGE_CHECK_COLS = CURVE.range_check_cols
FREQ_COL = LAYOUT.col("frequency")
RANGE_COUNTER_COL = LAYOUT.col("range_counter")

generate_trace_core = partial(scalar_mul.generate_trace_core, CURVE)
add_range_checks = partial(scalar_mul.add_range_checks, CURVE)
generate_trace = partial(scalar_mul.generate_trace, CURVE)
eval_g1_scalar_mul = partial(scalar_mul.eval_scalar_mul, CURVE)
lookups = partial(scalar_mul.lookups, CURVE)
ctls = partial(scalar_mul.ctls, CURVE)
generate_ctl_values = partial(scalar_mul.generate_ctl_values, CURVE)
