"""Leaf order of a polynomial-batch commitment.

Port of the parts of `plonky2_bn254_tpu/prover/poly_batch.py` the prover
uses: the Merkle tree of an LDE batch is built over its rows in bit-reversed
order, so FRI fold siblings are adjacent leaves (`prover/prove.py`
commits).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..field import ntt


@functools.lru_cache(maxsize=None)
def bit_rev_perm(n_log: int) -> np.ndarray:
    return ntt._bit_reverse_perm(n_log)


@functools.lru_cache(maxsize=None)
def bit_rev_perm_dev(n_log: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(bit_rev_perm(n_log)).to(device)


def leaf_rows(lde: torch.Tensor) -> torch.Tensor:
    """[n_polys, N] LDE -> [N, n_polys] leaf rows in bit-reversed order."""
    n_big = lde.shape[-1]
    perm = bit_rev_perm_dev(n_big.bit_length() - 1, lde.device)
    return lde[:, perm].T.contiguous()
