"""Tiny demo STARK machines for smoke tests.

Port of `plonky2_bn254_tpu/starks/demo.py`: a 5-column machine exercising
every prover subsystem (algebraic + transition + last-row constraints, a
LogUp range lookup and a filtered CTL), and a 6-column machine with a
keyed lookup.  Traces come back as int64 CPU tensors; callers move them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import goldilocks as gl
from ..interop import tensor_from_u64
from .table import CtlSpec, KeyedLookup, Lookup, Stark

DEMO_ROWS = 256
DEMO_N_CTL = 10


def _demo_eval(consumer, ring, local, next_):
    v, double, filt, freq, counter = local
    _, _, _, _, ncounter = next_
    consumer.constraint(double - v - v)
    diff = ncounter - counter
    consumer.constraint_transition(diff * diff - diff)
    consumer.constraint_last_row(counter - ring.const(DEMO_ROWS - 1))
    consumer.constraint(filt * filt - filt)


def demo_stark() -> Stark:
    return Stark(
        name="demo",
        width=5,
        eval_fn=_demo_eval,
        lookups=[Lookup(columns=[0], table_col=4, freq_col=3)],
        ctls=[CtlSpec(columns=[("single", 0), ("single", 1)], filter_col=2)],
    )


def _rows(cols) -> torch.Tensor:
    return tensor_from_u64(np.stack(cols, axis=1))


def demo_trace(rng: np.random.Generator):
    """Valid witness: column1 = 2·column0, range table + frequencies,
    CTL rows = the first DEMO_N_CTL (v, 2v) pairs."""
    v = rng.integers(0, DEMO_ROWS, size=DEMO_ROWS).astype(np.uint64)
    double = (2 * v.astype(object) % gl.P).astype(np.uint64)
    filt = np.zeros(DEMO_ROWS, dtype=np.uint64)
    filt[:DEMO_N_CTL] = 1
    freq = np.bincount(v.astype(np.int64), minlength=DEMO_ROWS).astype(np.uint64)
    counter = np.arange(DEMO_ROWS, dtype=np.uint64)
    ctl_values = {0: [[int(v[i]), int(double[i])] for i in range(DEMO_N_CTL)]}
    return _rows([v, double, filt, freq, counter]), ctl_values


def keyed_demo_stark() -> Stark:
    """6-column machine exercising KeyedLookup: looked-up (key, value)
    entries in cols (0, 1) must appear among the table rows
    (col 2 = key, col 3 = 3·key mod p) with frequencies in col 4; a CTL
    exposes the first DEMO_N_CTL entries. Col 5 is a filter."""

    def _eval(consumer, ring, local, next_):
        filt = local[5]
        consumer.constraint(filt * filt - filt)

    return Stark(
        name="keyed_demo",
        width=6,
        eval_fn=_eval,
        lookups=[KeyedLookup(pairs=[(0, 1)], table_key_col=2, table_val_col=3, freq_col=4)],
        ctls=[CtlSpec(columns=[("single", 0), ("single", 1)], filter_col=5)],
    )


def keyed_demo_trace(rng: np.random.Generator):
    idx = rng.integers(0, DEMO_ROWS, size=DEMO_ROWS).astype(np.uint64)
    key = idx
    val = (3 * idx.astype(object) % gl.P).astype(np.uint64)
    table_key = np.arange(DEMO_ROWS, dtype=np.uint64)
    table_val = (3 * table_key.astype(object) % gl.P).astype(np.uint64)
    freq = np.bincount(idx.astype(np.int64), minlength=DEMO_ROWS).astype(np.uint64)
    filt = np.zeros(DEMO_ROWS, dtype=np.uint64)
    filt[:DEMO_N_CTL] = 1
    ctl_values = {0: [[int(key[i]), int(val[i])] for i in range(DEMO_N_CTL)]}
    return _rows([key, val, table_key, table_val, freq, filt]), ctl_values
