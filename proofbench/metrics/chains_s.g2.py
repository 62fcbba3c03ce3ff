"""Seconds a proof of the "chains" span (the Jacobian chains and their affine
normalisation) under each "generate_trace" root span of the program, the
mean over the traced run's window proofs."""

from yardstick import spans


def read(record):
    return spans.mean_under("generate_trace", "chains")
