"""Histogram for the range-check frequency columns.

Port of `plonky2_bn254_tpu/starks/histogram.py`.  The JAX package built the
histogram from one-hot bf16 matmuls because TPU scatter-add ran serially;
on the card `torch.bincount` does it directly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bincount16(values: torch.Tensor, length: int) -> torch.Tensor:
    """Histogram of 16-bit `values` (any shape) over bins [0, 65536),
    zero-padded or truncated to `length` (int64 output)."""
    hist = torch.bincount(values.reshape(-1), minlength=1 << 16)[: 1 << 16]
    if length >= hist.shape[0]:
        return F.pad(hist, (0, length - hist.shape[0]))
    return hist[:length]
