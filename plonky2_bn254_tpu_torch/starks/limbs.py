"""U256 limb representation: 16 limbs x 16 bits (STARK side).

Port of `plonky2_bn254_tpu/starks/limbs.py`.  Tensor representation: int64
tensors with a trailing limb axis, values in [0, 2^16) (unsigned limbs) or
small signed ranges (polynomial coefficients).  int64 is exact for every
intermediate (products of 16-bit limbs summed over <= 49 terms < 2^42).
"""

from __future__ import annotations

import numpy as np
import torch

N_LIMBS = 16
LIMB_BITS = 16
N_BITS = 256
LIMB_MASK = (1 << LIMB_BITS) - 1


# ---------------------------------------------------------------------------
# Host converters (python ints)
# ---------------------------------------------------------------------------


def h_int_to_limbs(x: int, n: int = N_LIMBS) -> list:
    """Non-negative int -> n little-endian 16-bit limbs."""
    assert x >= 0 and x < 1 << (LIMB_BITS * n)
    return [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n)]


def h_limbs_to_int(limbs) -> int:
    """Little-endian limbs (any sign) -> int (columns_to_bigint semantics)."""
    return sum(int(c) << (LIMB_BITS * i) for i, c in enumerate(limbs))


def h_bits_le(x: int, n: int = N_BITS) -> list:
    return [(x >> i) & 1 for i in range(n)]


# ---------------------------------------------------------------------------
# Tensor converters
# ---------------------------------------------------------------------------


def from_ints(values, n: int = N_LIMBS, device=None) -> torch.Tensor:
    """List of python ints -> [len, n] int64 limb tensor."""
    arr = np.zeros((len(values), n), dtype=np.int64)
    for i, v in enumerate(values):
        arr[i] = h_int_to_limbs(int(v), n)
    return torch.from_numpy(arr).to(device)
