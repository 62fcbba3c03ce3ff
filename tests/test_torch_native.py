"""The port's native host Poseidon against its python versions and the JAX
package's host Poseidon.

`field/native.py` builds `csrc/host_poseidon.cpp` with the host C++ compiler
at first use; `h_permute`, `h_hash_no_pad`, `h_two_to_one` and
`MerkleTree.verify` go through it, with no fallback.  Exact integer
arithmetic: every comparison is equality.
"""

import numpy as np
import pytest

from plonky2_bn254_tpu.field import poseidon as jposeidon
from plonky2_bn254_tpu.prover.merkle import MerkleTree as JMerkleTree
from plonky2_bn254_tpu_torch.field import native, poseidon
from plonky2_bn254_tpu_torch.interop import tensor_from_u64
from plonky2_bn254_tpu_torch.prover.merkle import MerkleTree, build_tree

P = native.P
EDGE = [0, 1, 2, P - 2, P - 1, P, P + 1, 2**32 - 1, 2**32, 2**63, 2**64 - 2**32, 2**64 - 1]


def _states(n: int, seed: int) -> list:
    """n random 12-word states over the whole u64 range, the edge words in
    every position among them."""
    s = np.random.default_rng(seed).integers(0, 2**64 - 1, size=(n, 12), dtype=np.uint64,
                                             endpoint=True)
    for i, e in enumerate(EDGE):
        s[i, :] = e
        s[len(EDGE) + 12 * i : len(EDGE) + 12 * (i + 1)][np.arange(12), np.arange(12)] = e
    return [[int(v) for v in row] for row in s]


def test_permute_equals_plain_and_jax():
    for state in _states(1000, 1):
        got = poseidon.h_permute(state)
        assert got == poseidon.h_permute_plain(state), state
        assert got == jposeidon.h_permute(state), state


def test_hash_no_pad_equals_plain_and_jax():
    rng = np.random.default_rng(2)
    for state in _states(300, 3):
        inputs = (state * 4)[: int(rng.integers(0, 41))]
        got = poseidon.h_hash_no_pad(inputs)
        assert got == poseidon.h_hash_no_pad_plain(inputs), inputs
        assert got == jposeidon.h_hash_no_pad([v % P for v in inputs]), inputs


def test_two_to_one_equals_plain_and_jax():
    for state in _states(1000, 4):
        left, right = state[:4], state[4:8]
        got = poseidon.h_two_to_one(left, right)
        assert got == poseidon.h_two_to_one_plain(left, right)
        assert got == jposeidon.h_two_to_one([v % P for v in left], [v % P for v in right])


def test_verify_path_on_a_real_tree():
    """Accepts every leaf's path of a tree built by the prover's Merkle
    code (K1's plain version on the CPU), as the JAX verifier and the python
    chain do; rejects a flipped sibling, a flipped digest and a wrong index."""
    rng = np.random.default_rng(5)
    leaves = tensor_from_u64(rng.integers(0, P, size=(64, 7), dtype=np.uint64), "cpu")
    tree = build_tree(leaves, cap_height=2)
    for index in range(64):
        digest, path = tree.levels[0][index], tree.prove(index)
        h = [int(x) for x in digest]
        for k, sib in enumerate(path):
            pair = (sib, h) if index >> k & 1 else (h, sib)
            h = poseidon.h_two_to_one_plain(*pair)
        assert h == [int(x) for x in tree.cap[index >> len(path)]]
        assert MerkleTree.verify(digest, index, path, tree.cap)
        assert JMerkleTree.verify(digest, index, path, tree.cap)
        bad = [p.copy() for p in path]
        bad[index % len(bad)][index % 4] ^= 1
        assert not MerkleTree.verify(digest, index, bad, tree.cap)
        assert not JMerkleTree.verify(digest, index, bad, tree.cap)
        flipped = digest.copy()
        flipped[0] ^= 1
        assert not MerkleTree.verify(flipped, index, path, tree.cap)
        assert not MerkleTree.verify(digest, index ^ 1, path, tree.cap)


def test_library_is_built_from_the_port_source_by_digest():
    lib = native.library()
    assert lib._name == str(native.BUILD_DIR / f"libhostposeidon_{native._digest()}.so")
    assert native.SOURCE.parent == native.BUILD_DIR.parent / "csrc"
    assert "-march=native" not in native.CXX_FLAGS


def test_no_fallback_when_the_build_fails(monkeypatch, tmp_path):
    """Without a compiler the host hashes raise; nothing falls back to the
    python versions."""
    def no_cxx():
        raise RuntimeError("no host C++ compiler")

    monkeypatch.setattr(native, "_cxx", no_cxx)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    native.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="compiler"):
            poseidon.h_permute(list(range(12)))
        with pytest.raises(RuntimeError, match="compiler"):
            MerkleTree.verify([0] * 4, 0, [], np.zeros((1, 4), dtype=np.uint64))
    finally:
        native.library.cache_clear()  # the next call loads the real build again
