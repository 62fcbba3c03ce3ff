"""Merkle levels of the port (K1m's plain version, `hash_tree_levels_plain`,
and `merkle.device_tree_levels` on the CPU) against the JAX package's
`merkle.device_tree_levels` (its plain reference, as its own CPU tests run
it), at cap heights 0, 2 and 4, and a mesh's top levels as `sharded_tree`
builds them."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plonky2_bn254_tpu.prover import merkle as jmerkle
from plonky2_bn254_tpu_torch.field import poseidon_cuda
from plonky2_bn254_tpu_torch.interop import tensor_from_u64, u64_from_tensor
from plonky2_bn254_tpu_torch.prover import merkle

torch.set_num_threads(2)


@pytest.mark.parametrize("cap_height", [0, 2, 4])
def test_tree_levels_match_jax(cap_height):
    rng = np.random.default_rng(40 + cap_height)
    leaves = rng.integers(0, 2**64 - 1, (128, 11), dtype=np.uint64, endpoint=True)
    want = [np.asarray(v) for v in jmerkle.device_tree_levels(jnp.asarray(leaves), cap_height)]
    got = merkle.device_tree_levels(tensor_from_u64(leaves), cap_height)
    assert len(got) == len(want) == 8 - cap_height
    for g, w in zip(got, want):
        np.testing.assert_array_equal(u64_from_tensor(g), w)
    above = poseidon_cuda.hash_tree_levels_plain(got[0], 7 - cap_height)
    for g, w in zip(above, want[1:]):
        np.testing.assert_array_equal(u64_from_tensor(g), w)
    # the wrapper on a CPU tensor takes the plain version
    for g, w in zip(poseidon_cuda.hash_tree_levels(got[0], 7 - cap_height), above):
        assert torch.equal(g, w)


def test_two_leaves_and_no_levels():
    leaves = np.random.default_rng(3).integers(0, 2**63, (2, 5), dtype=np.uint64)
    want = [np.asarray(v) for v in jmerkle.device_tree_levels(jnp.asarray(leaves), 0)]
    got = merkle.device_tree_levels(tensor_from_u64(leaves), 0)
    assert [g.shape[0] for g in got] == [2, 1]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(u64_from_tensor(g), w)
    assert len(merkle.device_tree_levels(tensor_from_u64(leaves), 1)) == 1


def test_sharded_top_levels_are_the_tree_above_the_roots():
    """sharded_tree's shared top (the D subtree roots, then the levels above
    them to the cap) equals the single tree's levels, as it is built from
    `hash_tree_levels`."""
    leaves = np.random.default_rng(9).integers(0, 2**64 - 1, (64, 7), dtype=np.uint64, endpoint=True)
    full = merkle.device_tree_levels(tensor_from_u64(leaves), 0)
    d_log = 2  # four ranks, each a subtree of 16 leaves
    roots = torch.cat([merkle.device_tree_levels(tensor_from_u64(leaves[16 * r:16 * (r + 1)]), 0)[-1]
                       for r in range(4)])
    assert torch.equal(roots, full[-1 - d_log])
    top = poseidon_cuda.hash_tree_levels(roots, d_log)
    for g, w in zip(top, full[-d_log:]):
        assert torch.equal(g, w)
