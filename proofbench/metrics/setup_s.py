"""Seconds from the top of run.py to the window's first proof: imports, the
kernel build where the checkout has none, the driver's set-up and warm-up."""


def read(record):
    return record["setup_s"]
