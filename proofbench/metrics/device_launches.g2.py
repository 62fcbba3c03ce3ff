"""Device kernels launched in the profiled prove call (one proof's prove,
after its trace generation)."""

from yardstick import readers


def read(record):
    return readers.launches(record)
