"""Seconds a circuit proof in the outer proof's TimingTree scope "quotient",
the mean over the traced run's window proofs."""

from yardstick import readers


def read(record):
    return readers.span_mean(record, "quotient_s")
