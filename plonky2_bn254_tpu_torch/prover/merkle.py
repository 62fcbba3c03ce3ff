"""Poseidon Merkle tree with cap, built level by level on the device.

Port of `plonky2_bn254_tpu/prover/merkle.py`.  Leaves and every level go
through the leaf-sponge kernel K1 (`field/poseidon_cuda.py`): a level is the
sponge of `[m/2, 8]` pair rows, since two_to_one(l, r) == hash_no_pad(l || r).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..field import native, poseidon_cuda
from ..interop import u64_from_tensor


@dataclass
class MerkleTree:
    """levels[0] = leaf digests [N, 4]; levels[-1] = cap [2^cap_height, 4]."""

    levels: List[np.ndarray]

    @property
    def cap(self) -> np.ndarray:
        return self.levels[-1]

    def prove(self, index: int) -> List[np.ndarray]:
        """Sibling digests from leaf level up to (excluding) the cap."""
        path = []
        for level in self.levels[:-1]:
            path.append(level[index ^ 1])
            index >>= 1
        return path

    @staticmethod
    def verify(leaf_digest, index: int, path, cap) -> bool:
        """True when `path` leads from `leaf_digest` at `index` to its cap
        node (the native library's `verify_path`)."""
        return native.verify_path(leaf_digest, index, path, cap[index >> len(path)])


def device_tree_levels(leaves: torch.Tensor, cap_height: int) -> List[torch.Tensor]:
    """[N, L] leaf rows -> list of [m, 4] digest levels, leaf level first."""
    n = leaves.shape[0]
    n_levels = (n.bit_length() - 1) - cap_height
    assert n_levels >= 0, "cap larger than tree"
    digests = poseidon_cuda.hash_leaves(leaves.contiguous())
    levels = [digests]
    for _ in range(n_levels):
        pairs = digests.reshape(-1, 8)  # rows 2i, 2i+1 side by side
        digests = poseidon_cuda.hash_leaves(pairs)
        levels.append(digests)
    return levels


def build_tree(leaves: torch.Tensor, cap_height: int) -> MerkleTree:
    """[N, L] leaf rows -> MerkleTree (levels on the host) with 2^cap_height cap."""
    levels = device_tree_levels(leaves, cap_height)
    return MerkleTree(levels=[u64_from_tensor(lvl) for lvl in levels])


def gather_paths_dev(levels, idx: torch.Tensor) -> List[torch.Tensor]:
    """Sibling digests of the leaves `idx` at every level below the cap."""
    paths = []
    cur = idx
    for level in levels[:-1]:
        paths.append(level[cur ^ 1])
        cur = cur >> 1
    return paths


def gather_paths(levels, indices) -> List[np.ndarray]:
    """[Q] leaf indices -> per level below the cap, [Q, 4] numpy digests."""
    idx = torch.as_tensor(np.asarray(indices, dtype=np.int64), device=levels[0].device)
    return [u64_from_tensor(p) for p in gather_paths_dev(levels, idx)]


def gather_rows_and_paths(leaves: torch.Tensor, levels, indices):
    """([Q, w] numpy leaf rows, [height][Q, 4] numpy paths) for `indices`."""
    idx = torch.as_tensor(np.asarray(indices, dtype=np.int64), device=leaves.device)
    paths = [u64_from_tensor(p) for p in gather_paths_dev(levels, idx)]
    return u64_from_tensor(leaves[idx]), paths
