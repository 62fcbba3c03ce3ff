"""Self seconds a circuit proof of the program's "generate_witness" root span
(its seconds less its children's: the generator fixpoint around the hook),
the mean over the traced run's window proofs."""

from yardstick import spans


def read(record):
    return spans.mean_self_s("generate_witness")
