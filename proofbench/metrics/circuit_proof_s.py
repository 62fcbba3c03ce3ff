"""Seconds a circuit proof: the window, from the first proof's start to the
last one's end, over the circuit proofs it completed."""


def read(record):
    return record["window_s"] / record["proofs"] if record.get("proofs") else None
