"""Poseidon kernels K1 (leaf sponge) and K2 (raw permutation) for the H100.

Port of `plonky2_bn254_tpu/field/poseidon_pallas.py` (`hash_leaves`,
`permute_states`).  The kernels are `csrc/poseidon.cu`; the plain versions
beside them are the tensor Poseidon of `poseidon.py`.  A wrapper takes the
plain path only for a CPU tensor; for a CUDA tensor it launches its kernel
or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from . import poseidon
from .poseidon_constants import MDS, ROUND_CONSTANTS, WIDTH

_INITIALIZED = set()


def _lib(device: torch.device):
    lib = kernels.library()
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _INITIALIZED:
        rc = np.ascontiguousarray(ROUND_CONSTANTS, dtype=np.uint64)
        mds = np.ascontiguousarray(MDS, dtype=np.uint32)
        with torch.cuda.device(idx):
            kernels.check(
                lib.p2_poseidon_init(rc.ctypes.data, mds.ctypes.data),
                "poseidon constants",
            )
        _INITIALIZED.add(idx)
    return lib


def hash_leaves_plain(leaves: torch.Tensor) -> torch.Tensor:
    """[N, W] -> [N, 4]: the sponge of every row (plain version of K1)."""
    return poseidon.hash_no_pad(leaves)


def permute_states_plain(states: torch.Tensor) -> torch.Tensor:
    """[N, 12] -> [N, 12]: the permutation of every row (plain version of K2)."""
    return poseidon.permute(states)


def hash_leaves(leaves: torch.Tensor) -> torch.Tensor:
    """[N, W] int64 leaves -> [N, 4] Poseidon digests (K1)."""
    if kernels.is_plain(leaves):
        return hash_leaves_plain(leaves)
    kernels.require_cuda_int64(leaves, "hash_leaves", ndim=2)
    n, w = leaves.shape
    out = torch.empty((n, 4), dtype=torch.int64, device=leaves.device)
    if n:
        lib = _lib(leaves.device)
        kernels.check(
            lib.p2_hash_leaves(leaves.data_ptr(), out.data_ptr(), n, w,
                               kernels.stream_of(leaves)),
            "hash_leaves",
        )
        kernels.count_launch("K1", (n, w))
    return out


def permute_states(states: torch.Tensor) -> torch.Tensor:
    """[N, 12] int64 states -> [N, 12] Poseidon-permuted states (K2)."""
    if kernels.is_plain(states):
        return permute_states_plain(states)
    kernels.require_cuda_int64(states, "permute_states", ndim=2)
    n, w = states.shape
    if w != WIDTH:
        raise ValueError(f"permute_states: expected width {WIDTH}, got {w}")
    out = torch.empty_like(states)
    if n:
        lib = _lib(states.device)
        kernels.check(
            lib.p2_permute_states(states.data_ptr(), out.data_ptr(), n,
                                  kernels.stream_of(states)),
            "permute_states",
        )
        kernels.count_launch("K2", (n,))
    return out
