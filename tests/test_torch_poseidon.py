"""Poseidon of the PyTorch port against the JAX package.

The plain versions of kernels K1 (leaf sponge) and K2 (raw permutation) are
held against `poseidon.hash_no_pad` / `poseidon.permute`, the JAX package's
plain references for `poseidon_pallas`; the host mirror against the golden
vectors of tests/test_golden.py; the constant tables against the original.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plonky2_bn254_tpu.field import poseidon as jpos
from plonky2_bn254_tpu.field import poseidon_constants as jconst
from plonky2_bn254_tpu.prover.challenger import Challenger as JChallenger
from plonky2_bn254_tpu_torch.field import goldilocks as gl
from plonky2_bn254_tpu_torch.field import poseidon, poseidon_constants, poseidon_cuda
from plonky2_bn254_tpu_torch.interop import tensor_from_u64, u64_from_tensor
from plonky2_bn254_tpu_torch.prover.challenger import Challenger

from test_golden import (
    GOLDEN_CHALLENGE,
    GOLDEN_EXT,
    GOLDEN_HASH_0_7,
    GOLDEN_PERMUTE_0_11,
    GOLDEN_TWO_TO_ONE,
)

torch.set_num_threads(2)


def test_constant_tables_equal_original():
    np.testing.assert_array_equal(poseidon_constants.ROUND_CONSTANTS, jconst.ROUND_CONSTANTS)
    np.testing.assert_array_equal(poseidon_constants.MDS, jconst.MDS)
    for name in ["WIDTH", "ALPHA", "FULL_ROUNDS", "PARTIAL_ROUNDS", "N_ROUNDS",
                 "SPONGE_RATE", "SPONGE_CAPACITY", "DIGEST_LEN", "MDS_CIRC", "MDS_DIAG"]:
        assert getattr(poseidon_constants, name) == getattr(jconst, name), name


def test_host_golden_vectors():
    assert poseidon.h_permute(list(range(12))) == GOLDEN_PERMUTE_0_11
    assert poseidon.h_hash_no_pad(list(range(8))) == GOLDEN_HASH_0_7
    assert poseidon.h_two_to_one([1, 2, 3, 4], [5, 6, 7, 8]) == GOLDEN_TWO_TO_ONE


def test_tensor_golden_vectors():
    got = poseidon.permute(torch.arange(12, dtype=torch.int64)[None])
    assert [gl.u64(int(v)) for v in got[0]] == GOLDEN_PERMUTE_0_11
    got = poseidon_cuda.hash_leaves(torch.arange(8, dtype=torch.int64)[None])
    assert [gl.u64(int(v)) for v in got[0]] == GOLDEN_HASH_0_7


def test_challenger_golden_and_matches_jax():
    ch = Challenger()
    for x in range(5):
        ch.observe_element(x)
    assert ch.get_challenge() == GOLDEN_CHALLENGE
    ext = ch.get_extension_challenge()
    assert (ext.c0, ext.c1) == GOLDEN_EXT
    # a longer transcript: caps, extensions, forks
    a, b = Challenger(), JChallenger()
    rng = np.random.default_rng(1)
    for step in range(30):
        vals = [int(v) for v in rng.integers(0, gl.P, step % 11, dtype=np.uint64)]
        a.observe_elements(vals)
        b.observe_elements(vals)
        assert a.get_n_challenges(step % 3) == b.get_n_challenges(step % 3)
    assert a.fork().get_challenge() == b.fork().get_challenge()
    assert a.state == b.state


def test_host_mirror_matches_jax():
    rng = np.random.default_rng(2)
    for n in [0, 1, 8, 9, 30]:
        vals = [int(v) for v in rng.integers(0, gl.P, n, dtype=np.uint64)]
        assert poseidon.h_hash_no_pad(vals) == jpos.h_hash_no_pad(vals)
    s = [int(v) for v in rng.integers(0, 2**64 - 1, 12, dtype=np.uint64)]
    assert poseidon.h_permute(s) == jpos.h_permute(s)


def test_permute_states_plain_matches_jax():
    """K2's plain version against the JAX permutation, incl. non-canonical words."""
    rng = np.random.default_rng(3)
    s = rng.integers(0, 2**64 - 1, (64, 12), dtype=np.uint64, endpoint=True)
    s[0] = gl.P
    s[1] = 2**64 - 1
    want = np.asarray(jpos.permute(jnp.asarray(s)))
    np.testing.assert_array_equal(u64_from_tensor(poseidon_cuda.permute_states(tensor_from_u64(s))), want)


@pytest.mark.parametrize("width", [1, 2, 8, 13, 32, 781])
def test_hash_leaves_plain_matches_jax(width):
    """K1's plain version against the JAX sponge for leaf widths of every
    absorb shape, incl. the trace's 781 and the Merkle levels' 8."""
    rng = np.random.default_rng(width)
    leaves = rng.integers(0, 2**64 - 1, (5, width), dtype=np.uint64, endpoint=True)
    want = np.asarray(jpos.hash_no_pad(jnp.asarray(leaves)))
    got = u64_from_tensor(poseidon_cuda.hash_leaves(tensor_from_u64(leaves)))
    np.testing.assert_array_equal(got, want)


def test_two_to_one_matches_jax():
    rng = np.random.default_rng(4)
    l, r = (rng.integers(0, gl.P, (7, 4), dtype=np.uint64) for _ in range(2))
    want = np.asarray(jpos.two_to_one(jnp.asarray(l), jnp.asarray(r)))
    got = u64_from_tensor(poseidon.two_to_one(tensor_from_u64(l), tensor_from_u64(r)))
    np.testing.assert_array_equal(got, want)
    # a Merkle level hashed as [m, 8] pair rows is the same compression
    pairs = tensor_from_u64(np.concatenate([l, r], axis=1))
    np.testing.assert_array_equal(u64_from_tensor(poseidon_cuda.hash_leaves(pairs)), want)
