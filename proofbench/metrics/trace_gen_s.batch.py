"""Seconds of trace generation a proof (the statement and generate_trace,
synchronised), the mean over the traced run's window proofs."""

from yardstick import readers


def read(record):
    return readers.span_mean(record, "trace_gen_s")
