"""The device's idle share in the profiled prove call, %: one minus the
union of device operations' intervals over the window's wall."""

from yardstick import readers


def read(record):
    return readers.idle_percent(record)
