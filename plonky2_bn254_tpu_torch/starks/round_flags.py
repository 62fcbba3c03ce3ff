"""Periodic round-counter machinery shared by all STARK machines.

Port of `plonky2_bn254_tpu/starks/round_flags.py`: a counter cycling
0..period-1 with inverse-witnessed first/last-round flags (keeps the flag
constraints at degree <= 3).
"""

from __future__ import annotations

import functools

import numpy as np

from ..field import goldilocks as gl


@functools.lru_cache(maxsize=None)
def flag_tables(period: int):
    """Per-row-in-period constant columns, numpy uint64 [period, 5]:
    (is_first_round, is_last_round, counter, inv_counter, inv_counter_prime)."""
    out = np.zeros((period, 5), dtype=np.uint64)
    for i in range(period):
        counter = i
        counter_prime = (i - (period - 1)) % gl.P
        out[i, 0] = 1 if counter == 0 else 0
        out[i, 1] = 1 if counter == period - 1 else 0
        out[i, 2] = counter
        out[i, 3] = gl.h_inv(counter)
        out[i, 4] = gl.h_inv(counter_prime) if counter != period - 1 else 0
    return out


def eval_round_flags(consumer, ring, period: int, filt, flags, next_counter):
    """Ring-generic mirror of eval_round_flags (round_flags.rs:46-81)."""
    one = ring.one()
    not_filter = one - filt
    consumer.constraint(not_filter * flags["is_first_round"])
    consumer.constraint(not_filter * flags["is_last_round"])

    is_first_round_minus_one = one - flags["is_first_round"]
    consumer.constraint(
        filt * (flags["counter"] * flags["inv_counter"] - is_first_round_minus_one)
    )
    consumer.constraint(filt * flags["counter"] * flags["is_first_round"])

    counter_prime = flags["counter"] - ring.const(period - 1)
    is_last_round_minus_one = one - flags["is_last_round"]
    consumer.constraint(
        filt * (counter_prime * flags["inv_counter_prime"] - is_last_round_minus_one)
    )
    consumer.constraint(filt * counter_prime * flags["is_last_round"])

    is_not_last_round = one - flags["is_last_round"]
    consumer.constraint(
        filt * is_not_last_round * (next_counter - flags["counter"] - one)
    )
    consumer.constraint(filt * flags["is_last_round"] * next_counter)
