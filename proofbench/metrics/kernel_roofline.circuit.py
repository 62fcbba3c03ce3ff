"""The hand kernels' share of their roofline in the profiled prove_outer
call, %: the least time of the outer proof's commit, FRI and grind work
(yardstick/work.py) over the device time of the hand kernels."""

from yardstick import readers


def read(record):
    return readers.roofline_percent(record)
