"""Seconds a circuit proof of the hook's "fq_exp prove" span (the inner batch
STARK proof) under each "generate_witness" root span of the program, the
mean over the traced run's window proofs."""

from yardstick import spans


def read(record):
    return spans.mean_under("generate_witness", "fq_exp prove")
