"""Fq exponentiation, x^s in the BN254 base field, 512 rows an operation.

A frozen copy of the program's layout, transition constraints, range lookup
and two cross-table lookups; the statement (`ctl_values`) is x^s mod p on
python ints.
"""

from __future__ import annotations

from .. import bn254
from ..stark import (MOD_LIMBS, MODULUS_ZERO_AUX, N_BITS, N_LIMBS, PERIOD, ROUND_FLAGS, Ctl,
                     Layout, Machine, eval_eq, eval_fq_mul, eval_range_counter,
                     eval_round_flags, int_to_limbs, range_lookup, scalar_bits_cols)

LAYOUT = Layout([("square", N_LIMBS), ("product", N_LIMBS), ("a", N_LIMBS),
                ("b", N_LIMBS), ("c", N_LIMBS), ("mul_aux", MODULUS_ZERO_AUX),
                ("bits", N_BITS), ("round_flags", ROUND_FLAGS), ("timestamp", 1),
                ("is_mul", 1), ("is_sq_not_last", 1), ("filter", 1),
                ("frequency", 1), ("range_counter", 1)])


def eval_fq_exp(consumer, ring, local, next_):
    lv, nv = LAYOUT.view(local), LAYOUT.view(next_)
    modulus = [ring.const(m) for m in MOD_LIMBS]
    one, zero = ring.one(), ring.zero()
    is_not_last_round = lv["filter"] - lv["round_flags"]["is_last_round"]
    eval_fq_mul(consumer, ring, lv["filter"], modulus, lv["a"], lv["b"], lv["c"],
                lv["mul_aux"])
    first = lv["round_flags"]["is_first_round"]
    eval_eq(consumer, first, lv["is_mul"], one)
    eval_eq(consumer, first, lv["square"], lv["b"])
    eval_eq(consumer, lv["bits"][0] * first, lv["product"], lv["c"])
    eval_eq(consumer, (one - lv["bits"][0]) * first, lv["product"], lv["a"])
    eval_eq(consumer, first, lv["a"], [one] + [zero] * (N_LIMBS - 1))
    sq = lv["is_sq_not_last"]
    eval_eq(consumer, sq, nv["a"], lv["product"])
    eval_eq(consumer, sq, nv["b"], lv["square"])
    eval_eq(consumer, nv["bits"][0] * sq, nv["product"], nv["c"])
    eval_eq(consumer, (one - nv["bits"][0]) * sq, nv["product"], nv["a"])
    eval_eq(consumer, sq, nv["square"], lv["square"])
    eval_eq(consumer, sq, nv["is_mul"], one)
    eval_eq(consumer, sq, nv["is_sq_not_last"], zero)
    eval_eq(consumer, sq, nv["bits"], [lv["bits"][(i + 1) % N_BITS] for i in range(N_BITS)])
    mu = lv["is_mul"]
    is_next_not_last = nv["filter"] - nv["round_flags"]["is_last_round"]
    eval_eq(consumer, mu, nv["a"], lv["square"])
    eval_eq(consumer, mu, nv["b"], lv["square"])
    eval_eq(consumer, mu, nv["product"], lv["product"])
    eval_eq(consumer, mu, nv["square"], nv["c"])
    eval_eq(consumer, mu, nv["is_mul"], zero)
    eval_eq(consumer, mu, nv["is_sq_not_last"], is_next_not_last)
    eval_eq(consumer, mu, nv["bits"], lv["bits"])
    eval_round_flags(consumer, ring, PERIOD, lv["filter"], lv["round_flags"],
                     nv["round_flags"]["counter"])
    eval_eq(consumer, is_not_last_round, nv["timestamp"], lv["timestamp"])
    eval_eq(consumer, is_not_last_round, nv["filter"], lv["filter"])
    eval_range_counter(consumer, ring, lv, nv)


def fq_exp_ctls():
    lay = LAYOUT
    ts = lay.col("timestamp")
    inputs = [("single", lay.range("b").start + i) for i in range(N_LIMBS)]
    inputs += scalar_bits_cols(lay) + [("single", ts)]
    outputs = [("single", lay.range("product").start + i) for i in range(N_LIMBS)]
    return [Ctl(inputs, lay.col("round_flags", "is_first_round")),
            Ctl(outputs + [("single", ts)], lay.col("round_flags", "is_last_round"))]


def fq_exp_ctl_values(ops):
    """ops: (s, x) with timestamps their positions."""
    ins, outs = [], []
    for t, (s, x) in enumerate(ops):
        ins.append(int_to_limbs(x) + int_to_limbs(s) + [t])
        outs.append(int_to_limbs(pow(x, s, bn254.P)) + [t])
    return {0: ins, 1: outs}


def machine() -> Machine:
    return Machine("fq_exp", LAYOUT.width, eval_fq_exp,
                   range_lookup(LAYOUT, 2 * N_LIMBS, LAYOUT.range("mul_aux").stop),
                   fq_exp_ctls(), fq_exp_ctl_values)
