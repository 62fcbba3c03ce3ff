"""Seconds of prove_outer a circuit proof (the outer trace and its proof),
synchronised, the mean over the traced run's window proofs."""

from yardstick import readers


def read(record):
    return readers.span_mean(record, "outer_prove_s")
