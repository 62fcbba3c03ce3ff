"""Hierarchical timing scopes (plonky2's TimingTree), synchronised with CUDA.

Port of `plonky2_bn254_tpu/utils/timing.py`.  PyTorch queues CUDA work and
returns, so an unsynchronised host clock charges a stage for whatever the
card still had queued from earlier ones.  An enabled tree therefore
synchronises the card when a scope opens and when it closes, and each record
holds the time the card spent on that scope's work.  Enabled with env
PLONKY2_BN254_TPU_TIMING=1 or explicitly.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import List, Optional

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class TimingTree:
    def __init__(self, enabled: Optional[bool] = None):
        if enabled is None:
            enabled = os.environ.get("PLONKY2_BN254_TPU_TIMING", "0") == "1"
        self.enabled = enabled
        self.records: List[tuple] = []  # (depth, name, seconds)
        self._depth = 0

    @contextmanager
    def scope(self, name: str):
        if not self.enabled:
            yield
            return
        depth = self._depth
        self._depth += 1
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            self._depth = depth
            self.records.append((depth, name, time.perf_counter() - t0))

    def print(self, out=None):
        lines = []
        for depth, name, secs in self.records:
            lines.append(f"{'  ' * depth}{secs:8.3f}s  {name}")
        text = "\n".join(lines)
        if out is not None:
            out.write(text + "\n")
        else:
            print(text)
        return text

    def total(self, name: str) -> float:
        return sum(s for _, n, s in self.records if n == name)


_NULL = TimingTree(enabled=False)


def get(timing: Optional[TimingTree]) -> TimingTree:
    return timing if timing is not None else _NULL
