"""The device's idle share in the profiled prove_outer call, %."""

from yardstick import readers


def read(record):
    return readers.idle_percent(record)
