"""Inputs drawn from the seed.

A proof's inputs are a pure function of (seed, stream, proof index): the
window's proofs use stream "window", a warm-up "warmup", the traced run's
profiled proof "profile", the judge's sample "judge".  Each proof gets new
inputs, so no result can be cached, and two runs of one seed draw the same.
"""

from __future__ import annotations

import importlib
import re

import numpy as np

STREAMS = {"window": 0, "warmup": 1, "profile": 2, "judge": 3, "circuit": 4}


def rng(seed: int, stream: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), STREAMS[stream], index])


def draw(kind: str, g: np.random.Generator, spec: dict = None):
    """One value of the operand kind `kind`, from `operands/<kind>.py`."""
    if not re.fullmatch(r"[a-z][a-z0-9_]*", kind):
        raise ValueError(f"no operand kind named {kind!r}")
    return importlib.import_module(f"yardstick.operands.{kind}").draw(g, spec)


def operations(seed: int, stream: str, index: int, operands: list, count: int,
               scalar_spec: dict) -> list:
    """`count` operations, each a tuple with one value of every operand kind
    in `operands` (the configuration's), drawn in order."""
    g = rng(seed, stream, index)
    return [tuple(draw(kind, g, scalar_spec) for kind in operands) for _ in range(count)]
