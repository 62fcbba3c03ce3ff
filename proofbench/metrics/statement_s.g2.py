"""Seconds a proof of the program's host statement, the self time of each
"generate_ctl_values" root span (s * x + offset over Fq2 on python ints,
and the limbs of every input and output), the mean over the traced run's
window proofs."""

from yardstick import spans


def read(record):
    return spans.mean_self_s("generate_ctl_values")
