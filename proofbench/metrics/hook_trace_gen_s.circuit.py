"""Seconds a circuit proof of the hook's "fq_exp trace gen" span (the inner
batch trace) under each "generate_witness" root span of the program, the
mean over the traced run's window proofs."""

from yardstick import spans


def read(record):
    return spans.mean_under("generate_witness", "fq_exp trace gen")
