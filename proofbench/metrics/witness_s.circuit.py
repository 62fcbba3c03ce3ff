"""Seconds of generate_witness a circuit proof (the inner batch STARK traced,
proved, self-verified and injected; the fixpoint), synchronised, the mean
over the traced run's window proofs."""

from yardstick import readers


def read(record):
    return readers.span_mean(record, "witness_s")
