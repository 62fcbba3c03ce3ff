"""Seconds a circuit proof of the hook's "fq_exp self-verify" span under each
"generate_witness" root span of the program, the mean over the traced
run's window proofs."""

from yardstick import spans


def read(record):
    return spans.mean_under("generate_witness", "fq_exp self-verify")
