"""Merkle trees of the PyTorch port against the JAX package: every level,
the cap and the sibling paths at cap heights 0, 1 and 4."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plonky2_bn254_tpu.prover import merkle as jmerkle
from plonky2_bn254_tpu.prover import poly_batch as jpoly
from plonky2_bn254_tpu_torch.field import poseidon
from plonky2_bn254_tpu_torch.interop import tensor_from_u64, u64_from_tensor
from plonky2_bn254_tpu_torch.prover import merkle, poly_batch
from plonky2_bn254_tpu_torch.prover.config import StarkConfig
from plonky2_bn254_tpu_torch.prover.prove import commit_values

torch.set_num_threads(2)


@pytest.mark.parametrize("cap_height", [0, 1, 4])
def test_tree_levels_and_paths_match_jax(cap_height):
    rng = np.random.default_rng(cap_height)
    leaves = rng.integers(0, 2**64 - 1, (64, 13), dtype=np.uint64, endpoint=True)
    jtree = jmerkle.build_tree(jnp.asarray(leaves), cap_height)
    ttree = merkle.build_tree(tensor_from_u64(leaves), cap_height)
    assert len(ttree.levels) == len(jtree.levels) == 7 - cap_height
    for got, want in zip(ttree.levels, jtree.levels):
        np.testing.assert_array_equal(got, want)
    idx = np.array([0, 1, 17, 40, 63])
    levels = merkle.device_tree_levels(tensor_from_u64(leaves), cap_height)
    paths = merkle.gather_paths(levels, idx)
    for qi, i in enumerate(idx):
        want_path = jtree.prove(int(i))
        assert len(want_path) == len(paths)
        for lvl, w in zip(paths, want_path):
            np.testing.assert_array_equal(lvl[qi], w)
        digest = poseidon.h_hash_no_pad([int(v) for v in leaves[i]])
        assert merkle.MerkleTree.verify(digest, int(i), ttree.prove(int(i)), ttree.cap)
        assert not merkle.MerkleTree.verify(digest, int(i) ^ 1, ttree.prove(int(i)), ttree.cap)


def test_rows_and_paths_gather():
    rng = np.random.default_rng(9)
    leaves = rng.integers(0, 2**64 - 1, (32, 6), dtype=np.uint64, endpoint=True)
    t = tensor_from_u64(leaves)
    levels = merkle.device_tree_levels(t, 2)
    rows, paths = merkle.gather_rows_and_paths(t, levels, [3, 30])
    np.testing.assert_array_equal(rows, leaves[[3, 30]])
    jrows, jpaths = jmerkle.gather_rows_and_paths(
        jnp.asarray(leaves), jmerkle.device_tree_levels(jnp.asarray(leaves), 2), np.array([3, 30])
    )
    np.testing.assert_array_equal(rows, jrows)
    for a, b in zip(paths, jpaths):
        np.testing.assert_array_equal(a, b)


def test_commit_matches_jax_polynomial_batch():
    """The prover's commit (iNTT, coset LDE, bit-reversed leaf rows, tree)
    against the JAX package's PolynomialBatch."""
    values = np.random.default_rng(5).integers(0, 2**63, (5, 32), dtype=np.uint64)
    jb = jpoly.from_values(jnp.asarray(values), 1, 2)
    coeffs, lde, levels = commit_values(tensor_from_u64(values), StarkConfig(cap_height=2))
    np.testing.assert_array_equal(u64_from_tensor(coeffs), np.asarray(jb.coeffs))
    np.testing.assert_array_equal(u64_from_tensor(lde), np.asarray(jb.lde))
    np.testing.assert_array_equal(u64_from_tensor(levels[-1]), jb.cap)
    np.testing.assert_array_equal(poly_batch.bit_rev_perm(6), jpoly.bit_rev_perm(6))
