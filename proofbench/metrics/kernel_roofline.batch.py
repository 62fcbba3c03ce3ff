"""The hand kernels' share of their roofline in the profiled prove call, %:
the least time of the work they stand for, reckoned from the cell's shapes
and configuration (the commits' iNTTs, LDEs, leaf hashes and Merkle levels,
the FRI layers, the proof-of-work grind), over the device time of the
kernels yardstick/readers.py names."""

from yardstick import readers


def read(record):
    return readers.roofline_percent(record)
