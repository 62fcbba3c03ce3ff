"""Device seconds of a proof's prove call: the union of the device
operations' intervals while the last window proof's trace is proved once
more under the profiler (yardstick/profile.py).  The device's own clock
times it, so the host's speed, which sets the window's walls, does not."""

from yardstick import readers


def read(record):
    return readers.busy_s(record)
