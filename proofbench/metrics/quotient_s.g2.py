"""Seconds a proof in the program's TimingTree scope "quotient" (it
synchronises at open and close), the mean over the traced run's window
proofs."""

from yardstick import readers


def read(record):
    return readers.span_mean(record, "quotient_s")
