"""G1 scalar multiplication, s * x + offset on BN254, 512 rows an operation.

A frozen copy of the program's layout, transition constraints, range lookup
and two cross-table lookups; the statement (`ctl_values`) is worked out
from the operations' inputs by BN254 arithmetic on python ints.
"""

from __future__ import annotations

from .. import bn254
from ..stark import (IS_MODULUS_ZERO_AUX, MOD_LIMBS, MODULUS_ZERO_AUX, N_BITS, N_LIMBS, PERIOD,
                     ROUND_FLAGS, Ctl, Layout, Machine, eval_eq, eval_is_modulus_zero,
                     eval_modulus_zero, eval_range_counter, eval_round_flags, int_to_limbs,
                     pol_add, pol_mul_scalar, pol_mul_wide, pol_sub, range_lookup,
                     scalar_bits_cols)

G1_ADD_AUX = Layout([("is_x_eq", 1), ("is_x_eq_aux", IS_MODULUS_ZERO_AUX),
                     ("is_x_eq_filter", 1), ("lambda", 16), ("lambda_aux", MODULUS_ZERO_AUX),
                     ("x_aux", MODULUS_ZERO_AUX), ("y_aux", MODULUS_ZERO_AUX)])
POINT = Layout([("x", N_LIMBS), ("y", N_LIMBS)])

LAYOUT = Layout([("double", POINT), ("sum", POINT), ("a", POINT), ("b", POINT),
                ("c", POINT), ("add_aux", G1_ADD_AUX), ("bits", N_BITS),
                ("round_flags", ROUND_FLAGS), ("timestamp", 1), ("is_adding", 1),
                ("is_doubling_not_last", 1), ("filter", 1), ("frequency", 1),
                ("range_counter", 1)])


def eval_g1_add(consumer, ring, filt, modulus, a, b, c, aux):
    """Affine add or double, chosen by whether the x coordinates agree."""
    delta_x = [b["x"][i] - a["x"][i] for i in range(N_LIMBS)]
    eval_is_modulus_zero(consumer, ring, filt, modulus, delta_x, aux["is_x_eq"],
                         aux["is_x_eq_aux"])
    x_eq_filter = aux["is_x_eq_filter"]
    consumer.constraint(filt * aux["is_x_eq"] - x_eq_filter)
    not_eq_filter = filt - x_eq_filter
    lam = aux["lambda"]
    delta_y = [b["y"][i] - a["y"][i] for i in range(N_LIMBS)]
    eval_modulus_zero(consumer, ring, not_eq_filter, modulus,
                      pol_sub(pol_mul_wide(lam, delta_x), delta_y), aux["lambda_aux"])
    three_x_sq = pol_mul_scalar(pol_mul_wide(a["x"], a["x"]), 3)
    two_lambda_y = pol_mul_scalar(pol_mul_wide(lam, a["y"]), 2)
    eval_modulus_zero(consumer, ring, x_eq_filter, modulus,
                      [p - q for p, q in zip(two_lambda_y, three_x_sq)], aux["lambda_aux"])
    eval_eq(consumer, x_eq_filter, a["y"], b["y"])
    sum_x = [a["x"][i] + b["x"][i] + c["x"][i] for i in range(N_LIMBS)]
    eval_modulus_zero(consumer, ring, filt, modulus, pol_sub(pol_mul_wide(lam, lam), sum_x),
                      aux["x_aux"])
    c_x_sub_a_x = [c["x"][i] - a["x"][i] for i in range(N_LIMBS)]
    c_y_a_y = [c["y"][i] + a["y"][i] for i in range(N_LIMBS)]
    eval_modulus_zero(consumer, ring, filt, modulus,
                      pol_add(pol_mul_wide(lam, c_x_sub_a_x), c_y_a_y), aux["y_aux"])


def _sum(p):
    """A point's x limbs then its y limbs (a list of 32 values)."""
    return p["x"] + p["y"]


def eval_g1(consumer, ring, local, next_):
    lv, nv = LAYOUT.view(local), LAYOUT.view(next_)
    modulus = [ring.const(m) for m in MOD_LIMBS]
    one, zero = ring.one(), ring.zero()
    is_next_not_last = nv["filter"] - nv["round_flags"]["is_last_round"]
    is_not_last_round = lv["filter"] - lv["round_flags"]["is_last_round"]
    eval_g1_add(consumer, ring, lv["filter"], modulus, lv["a"], lv["b"], lv["c"],
                lv["add_aux"])
    first = lv["round_flags"]["is_first_round"]
    eval_eq(consumer, first, lv["is_adding"], one)
    eval_eq(consumer, first, _sum(lv["double"]), _sum(lv["b"]))
    eval_eq(consumer, lv["bits"][0] * first, _sum(lv["sum"]), _sum(lv["c"]))
    eval_eq(consumer, (one - lv["bits"][0]) * first, _sum(lv["sum"]), _sum(lv["a"]))
    dbl = lv["is_doubling_not_last"]
    eval_eq(consumer, dbl, _sum(nv["a"]), _sum(lv["sum"]))
    eval_eq(consumer, dbl, _sum(nv["b"]), _sum(lv["double"]))
    eval_eq(consumer, nv["bits"][0] * dbl, _sum(nv["sum"]), _sum(nv["c"]))
    eval_eq(consumer, (one - nv["bits"][0]) * dbl, _sum(nv["sum"]), _sum(nv["a"]))
    eval_eq(consumer, dbl, _sum(nv["double"]), _sum(lv["double"]))
    eval_eq(consumer, dbl, nv["is_adding"], one)
    eval_eq(consumer, dbl, nv["is_doubling_not_last"], zero)
    eval_eq(consumer, dbl, nv["bits"], [lv["bits"][(i + 1) % N_BITS] for i in range(N_BITS)])
    ad = lv["is_adding"]
    eval_eq(consumer, ad, _sum(nv["a"]), _sum(lv["double"]))
    eval_eq(consumer, ad, _sum(nv["b"]), _sum(lv["double"]))
    eval_eq(consumer, ad, _sum(nv["sum"]), _sum(lv["sum"]))
    eval_eq(consumer, ad, _sum(nv["double"]), _sum(nv["c"]))
    eval_eq(consumer, ad, nv["is_adding"], zero)
    eval_eq(consumer, ad, nv["is_doubling_not_last"], is_next_not_last)
    eval_eq(consumer, ad, nv["bits"], lv["bits"])
    eval_round_flags(consumer, ring, PERIOD, lv["filter"], lv["round_flags"],
                     nv["round_flags"]["counter"])
    eval_eq(consumer, is_not_last_round, nv["timestamp"], lv["timestamp"])
    eval_eq(consumer, is_not_last_round, nv["filter"], lv["filter"])
    eval_range_counter(consumer, ring, lv, nv)


def g1_ctls():
    lay, g1_len = LAYOUT, 2 * N_LIMBS
    ts = lay.col("timestamp")
    inputs = [("single", lay.range("b").start + i) for i in range(g1_len)]
    inputs += [("single", lay.range("a").start + i) for i in range(g1_len)]
    inputs += scalar_bits_cols(lay) + [("single", ts)]
    outputs = [("single", lay.range("sum").start + i) for i in range(g1_len)] + [("single", ts)]
    return [Ctl(inputs, lay.col("round_flags", "is_first_round")),
            Ctl(outputs, lay.col("round_flags", "is_last_round"))]


def g1_ctl_values(ops):
    """ops: (s, (x, y), (ox, oy)) with timestamps their positions."""
    ins, outs = [], []
    for t, (s, x, offset) in enumerate(ops):
        ins.append(int_to_limbs(x[0]) + int_to_limbs(x[1]) + int_to_limbs(offset[0])
                   + int_to_limbs(offset[1]) + int_to_limbs(s) + [t])
        out = bn254.g1_add(bn254.g1_mul(x, s), offset)
        outs.append(int_to_limbs(out[0]) + int_to_limbs(out[1]) + [t])
    return {0: ins, 1: outs}


def machine() -> Machine:
    return Machine("g1_scalar_mul", LAYOUT.width, eval_g1,
                   range_lookup(LAYOUT, 4 * N_LIMBS, LAYOUT.range("add_aux").stop), g1_ctls(),
                   g1_ctl_values)
