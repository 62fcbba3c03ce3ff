"""Device kernels launched in the profiled prove_outer call."""

from yardstick import readers


def read(record):
    return readers.launches(record)
