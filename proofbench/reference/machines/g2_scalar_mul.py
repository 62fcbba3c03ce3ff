"""G2 scalar multiplication, s * x + offset on BN254's twist, 512 rows an
operation.

A frozen copy of the program's layout (G1's machine with each coordinate
an Fq2 element, c0's 16 limbs then c1's), transition constraints, range
lookup and two cross-table lookups; the statement (`ctl_values`) is worked
out from the operations' inputs by G2 arithmetic on python ints.

An Fq2 product c = a b is checked as two wide limb polynomials,
c0 = a0 b0 - a1 b1 and c1 = a0 b1 + a1 b0, each with its own modulus-zero
witness.
"""

from __future__ import annotations

from .. import bn254_g2
from ..stark import (IS_MODULUS_ZERO_AUX, MOD_LIMBS, MODULUS_ZERO_AUX, N_BITS, N_LIMBS, PERIOD,
                     ROUND_FLAGS, Ctl, Layout, Machine, eval_eq, eval_is_modulus_zero,
                     eval_modulus_zero, eval_range_counter, eval_round_flags, int_to_limbs,
                     pol_add, pol_mul_wide, pol_sub, range_lookup, scalar_bits_cols)

G2_LEN = 4 * N_LIMBS  # a point: x0, x1, y0, y1
EXT_MODULUS_ZERO_AUX = Layout([("c0_aux", MODULUS_ZERO_AUX), ("c1_aux", MODULUS_ZERO_AUX)])
IS_EXT_MODULUS_ZERO_AUX = Layout([("is_c0_zero", 1), ("is_c1_zero", 1),
                                  ("c0_aux", IS_MODULUS_ZERO_AUX),
                                  ("c1_aux", IS_MODULUS_ZERO_AUX)])
G2_ADD_AUX = Layout([("is_x_eq", 1), ("is_x_eq_aux", IS_EXT_MODULUS_ZERO_AUX),
                     ("is_x_eq_filter", 1), ("lambda", 2 * N_LIMBS),
                     ("lambda_aux", EXT_MODULUS_ZERO_AUX), ("x_aux", EXT_MODULUS_ZERO_AUX),
                     ("y_aux", EXT_MODULUS_ZERO_AUX)])
POINT = Layout([("x", 2 * N_LIMBS), ("y", 2 * N_LIMBS)])

LAYOUT = Layout([("double", POINT), ("sum", POINT), ("a", POINT), ("b", POINT),
                ("c", POINT), ("add_aux", G2_ADD_AUX), ("bits", N_BITS),
                ("round_flags", ROUND_FLAGS), ("timestamp", 1), ("is_adding", 1),
                ("is_doubling_not_last", 1), ("filter", 1), ("frequency", 1),
                ("range_counter", 1)])


def _fq2(limbs):
    """32 column values -> (c0's 16, c1's 16)."""
    return limbs[:N_LIMBS], limbs[N_LIMBS:]


def _add(a, b):
    return [x + y for x, y in zip(a[0], b[0])], [x + y for x, y in zip(a[1], b[1])]


def _sub(a, b):
    return [x - y for x, y in zip(a[0], b[0])], [x - y for x, y in zip(a[1], b[1])]


def _mul_wide(a, b):
    """(a0 b0 - a1 b1, a0 b1 + a1 b0) as 31-coefficient polynomials."""
    return (pol_sub(pol_mul_wide(a[0], b[0]), pol_mul_wide(a[1], b[1])),
            pol_add(pol_mul_wide(a[0], b[1]), pol_mul_wide(a[1], b[0])))


def eval_fq2_modulus_zero(consumer, ring, filt, modulus, wide, aux):
    eval_modulus_zero(consumer, ring, filt, modulus, wide[0], aux["c0_aux"])
    eval_modulus_zero(consumer, ring, filt, modulus, wide[1], aux["c1_aux"])


def eval_fq2_is_zero(consumer, ring, filt, modulus, value, is_zero, aux):
    """is_zero = 1 exactly where both components are 0 mod p."""
    consumer.constraint(filt * (aux["is_c0_zero"] * aux["is_c1_zero"] - is_zero))
    eval_is_modulus_zero(consumer, ring, filt, modulus, value[0], aux["is_c0_zero"],
                         aux["c0_aux"])
    eval_is_modulus_zero(consumer, ring, filt, modulus, value[1], aux["is_c1_zero"],
                         aux["c1_aux"])


def eval_g2_add(consumer, ring, filt, modulus, a, b, c, aux):
    """Affine add or double over Fq2, chosen by whether the x coordinates
    agree."""
    ax, ay, bx, by = _fq2(a["x"]), _fq2(a["y"]), _fq2(b["x"]), _fq2(b["y"])
    cx, cy = _fq2(c["x"]), _fq2(c["y"])
    delta_x = _sub(bx, ax)
    eval_fq2_is_zero(consumer, ring, filt, modulus, delta_x, aux["is_x_eq"], aux["is_x_eq_aux"])
    x_eq_filter = aux["is_x_eq_filter"]
    consumer.constraint(filt * aux["is_x_eq"] - x_eq_filter)
    not_eq_filter = filt - x_eq_filter
    lam = _fq2(aux["lambda"])
    lam_dx, delta_y = _mul_wide(lam, delta_x), _sub(by, ay)
    eval_fq2_modulus_zero(consumer, ring, not_eq_filter, modulus,
                          (pol_sub(lam_dx[0], delta_y[0]), pol_sub(lam_dx[1], delta_y[1])),
                          aux["lambda_aux"])
    x_sq, lam_y = _mul_wide(ax, ax), _mul_wide(lam, ay)
    tangent = tuple([p.scalar_mul(2) - q.scalar_mul(3) for p, q in zip(lam_y[k], x_sq[k])]
                    for k in range(2))
    eval_fq2_modulus_zero(consumer, ring, x_eq_filter, modulus, tangent, aux["lambda_aux"])
    eval_eq(consumer, x_eq_filter, a["y"], b["y"])
    lam_sq, sum_x = _mul_wide(lam, lam), _add(_add(ax, bx), cx)
    eval_fq2_modulus_zero(consumer, ring, filt, modulus,
                          (pol_sub(lam_sq[0], sum_x[0]), pol_sub(lam_sq[1], sum_x[1])),
                          aux["x_aux"])
    lam_cx, cy_ay = _mul_wide(lam, _sub(cx, ax)), _add(cy, ay)
    eval_fq2_modulus_zero(consumer, ring, filt, modulus,
                          (pol_add(lam_cx[0], cy_ay[0]), pol_add(lam_cx[1], cy_ay[1])),
                          aux["y_aux"])


def _pt(p):
    """A point's x limbs then its y limbs (a list of 64 values)."""
    return p["x"] + p["y"]


def eval_g2(consumer, ring, local, next_):
    lv, nv = LAYOUT.view(local), LAYOUT.view(next_)
    modulus = [ring.const(m) for m in MOD_LIMBS]
    one, zero = ring.one(), ring.zero()
    is_next_not_last = nv["filter"] - nv["round_flags"]["is_last_round"]
    is_not_last_round = lv["filter"] - lv["round_flags"]["is_last_round"]
    eval_g2_add(consumer, ring, lv["filter"], modulus, lv["a"], lv["b"], lv["c"],
                lv["add_aux"])
    first = lv["round_flags"]["is_first_round"]
    eval_eq(consumer, first, lv["is_adding"], one)
    eval_eq(consumer, first, _pt(lv["double"]), _pt(lv["b"]))
    eval_eq(consumer, lv["bits"][0] * first, _pt(lv["sum"]), _pt(lv["c"]))
    eval_eq(consumer, (one - lv["bits"][0]) * first, _pt(lv["sum"]), _pt(lv["a"]))
    dbl = lv["is_doubling_not_last"]
    eval_eq(consumer, dbl, _pt(nv["a"]), _pt(lv["sum"]))
    eval_eq(consumer, dbl, _pt(nv["b"]), _pt(lv["double"]))
    eval_eq(consumer, nv["bits"][0] * dbl, _pt(nv["sum"]), _pt(nv["c"]))
    eval_eq(consumer, (one - nv["bits"][0]) * dbl, _pt(nv["sum"]), _pt(nv["a"]))
    eval_eq(consumer, dbl, _pt(nv["double"]), _pt(lv["double"]))
    eval_eq(consumer, dbl, nv["is_adding"], one)
    eval_eq(consumer, dbl, nv["is_doubling_not_last"], zero)
    eval_eq(consumer, dbl, nv["bits"], [lv["bits"][(i + 1) % N_BITS] for i in range(N_BITS)])
    ad = lv["is_adding"]
    eval_eq(consumer, ad, _pt(nv["a"]), _pt(lv["double"]))
    eval_eq(consumer, ad, _pt(nv["b"]), _pt(lv["double"]))
    eval_eq(consumer, ad, _pt(nv["sum"]), _pt(lv["sum"]))
    eval_eq(consumer, ad, _pt(nv["double"]), _pt(nv["c"]))
    eval_eq(consumer, ad, nv["is_adding"], zero)
    eval_eq(consumer, ad, nv["is_doubling_not_last"], is_next_not_last)
    eval_eq(consumer, ad, nv["bits"], lv["bits"])
    eval_round_flags(consumer, ring, PERIOD, lv["filter"], lv["round_flags"],
                     nv["round_flags"]["counter"])
    eval_eq(consumer, is_not_last_round, nv["timestamp"], lv["timestamp"])
    eval_eq(consumer, is_not_last_round, nv["filter"], lv["filter"])
    eval_range_counter(consumer, ring, lv, nv)


def g2_ctls():
    lay, ts = LAYOUT, LAYOUT.col("timestamp")
    inputs = [("single", lay.range("b").start + i) for i in range(G2_LEN)]
    inputs += [("single", lay.range("a").start + i) for i in range(G2_LEN)]
    inputs += scalar_bits_cols(lay) + [("single", ts)]
    outputs = [("single", lay.range("sum").start + i) for i in range(G2_LEN)] + [("single", ts)]
    return [Ctl(inputs, lay.col("round_flags", "is_first_round")),
            Ctl(outputs, lay.col("round_flags", "is_last_round"))]


def _point_limbs(pt):
    (x0, x1), (y0, y1) = pt
    return int_to_limbs(x0) + int_to_limbs(x1) + int_to_limbs(y0) + int_to_limbs(y1)


def g2_ctl_values(ops):
    """ops: (s, x, offset), points ((x0, x1), (y0, y1)), with timestamps
    their positions."""
    ins, outs = [], []
    for t, (s, x, offset) in enumerate(ops):
        ins.append(_point_limbs(x) + _point_limbs(offset) + int_to_limbs(s) + [t])
        outs.append(_point_limbs(bn254_g2.g2_mul_add(x, s, offset)) + [t])
    return {0: ins, 1: outs}


def machine() -> Machine:
    return Machine("g2_scalar_mul", LAYOUT.width, eval_g2,
                   range_lookup(LAYOUT, 2 * G2_LEN, LAYOUT.range("add_aux").stop), g2_ctls(),
                   g2_ctl_values)
