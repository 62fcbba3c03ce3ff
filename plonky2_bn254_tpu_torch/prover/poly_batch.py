"""Leaf order of a polynomial-batch commitment.

Port of the parts of `plonky2_bn254_tpu/prover/poly_batch.py` the prover
uses: the Merkle tree of an LDE batch is built over its rows in bit-reversed
order, so FRI fold siblings are adjacent leaves (`prover/prove.py`
commits).  On a mesh (`sharded_leaf_rows`) each rank holds a contiguous
block of those leaves.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..field import ntt
from ..parallel.mesh import Mesh, all_to_all


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


def sharded_leaf_rows(lde: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's `[k, N/D]` block of an LDE in natural order -> its
    `[N/D, k]` contiguous block of the bit-reversed leaf rows, by one
    all-to-all.  Leaf r N/D + u is LDE point rev(u) D + rev_d(r) (rev over
    log2(N/D) bits, rev_d over log2 D), so rank r gathers the points
    congruent to rev_d(r) mod D from every rank, in order, and reverses
    their index locally."""
    k, nb = lde.shape
    D = mesh.size
    d_log = D.bit_length() - 1
    if nb % D:
        raise ValueError(f"sharded_leaf_rows: a block of {nb} points does not split over {D} ranks")
    # [k, nb/D, D(residue)], residues reordered so that piece t goes to rank t
    by_dest = lde.reshape(k, nb // D, D)[:, :, bit_rev_perm_dev(d_log, lde.device)]
    got = all_to_all(mesh, by_dest, split_axis=2, concat_axis=1).reshape(k, nb)
    return got[:, bit_rev_perm_dev(nb.bit_length() - 1, lde.device)].T.contiguous()
