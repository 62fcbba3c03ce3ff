"""Poseidon Merkle tree with cap, built level by level on the device.

Port of `plonky2_bn254_tpu/prover/merkle.py`.  The leaves go through the
leaf-sponge kernel K1 and the levels above them through
`poseidon_cuda.hash_tree_levels` (`field/poseidon_cuda.py`): a level is the
sponge of `[m/2, 8]` pair rows, since two_to_one(l, r) == hash_no_pad(l || r);
the levels that fill the card are one K1 launch each, all the others one
K1m launch.
On a mesh (`ShardedTree`) each rank hashes its contiguous block of leaves
into its own subtree; only the subtree roots or the cap are gathered.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..field import native, poseidon_cuda
from ..interop import u64_from_tensor
from ..parallel.mesh import Mesh, all_gather


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
    return [digests] + poseidon_cuda.hash_tree_levels(digests, n_levels)


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


@dataclass
class ShardedTree:
    """A Merkle tree whose leaves lie in contiguous blocks over the ranks of
    a mesh.  `local`: this rank's subtree levels, leaf digests first; `top`:
    the levels above them, the same on every rank, ending in the cap."""

    local: List[torch.Tensor]
    top: List[torch.Tensor]

    @property
    def cap(self) -> torch.Tensor:
        return self.top[-1]

    def paths(self, idx: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
        """Sibling digests below the cap of the global leaves `idx` ([Q],
        the same on every rank): the owner rank's subtree path, gathered,
        then the shared top levels."""
        block = self.local[0].shape[0]
        owner = idx // block
        local = gather_paths_dev(self.local, idx % block)
        if local:
            mine = torch.stack(local, dim=1)  # [Q, subtree levels, 4], valid where owner == rank
            every = all_gather(mesh, mine[None], axis=0)
            local = list(every[owner, torch.arange(idx.shape[0], device=idx.device)].unbind(1))
        return local + gather_paths_dev(self.top, owner)


def sharded_tree(leaves: torch.Tensor, cap_height: int, mesh: Mesh) -> ShardedTree:
    """This rank's `[N/D, L]` block of leaf rows -> its `ShardedTree` with a
    2^cap_height cap.  Cap height >= log2 D: the cap nodes lie inside the
    subtrees and only the cap is gathered; below it, the D subtree roots are
    gathered and the levels above them built on every rank."""
    d_log = mesh.size.bit_length() - 1
    if cap_height >= d_log:
        local = device_tree_levels(leaves, cap_height - d_log)
        return ShardedTree(local=local, top=[all_gather(mesh, local[-1], axis=0)])
    local = device_tree_levels(leaves, 0)
    roots = all_gather(mesh, local[-1], axis=0)
    return ShardedTree(local=local,
                       top=[roots] + poseidon_cuda.hash_tree_levels(roots, d_log - cap_height))
