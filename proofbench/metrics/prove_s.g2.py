"""Seconds of the prove call a proof (synchronised), the mean over the
traced run's window proofs."""

from yardstick import readers


def read(record):
    return readers.span_mean(record, "prove_s")
