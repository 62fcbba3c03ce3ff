"""Hand-written CUDA kernels K1-K4 against their plain PyTorch versions.

These need an NVIDIA card with nvcc and skip without one.  On the card:
    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest
(`--noconftest`: tests/conftest.py sets up JAX, which the card's machine
need not have; this file imports none.  chip_smoke.py runs the same
comparisons at the main path's full shapes.)
"""

import json

import numpy as np
import pytest
import torch

from plonky2_bn254_tpu_torch import kernels
from plonky2_bn254_tpu_torch.field import goldilocks as gl
from plonky2_bn254_tpu_torch.field import ntt_cuda, poseidon_cuda
from plonky2_bn254_tpu_torch.interop import proof_to_fields, tensor_from_u64

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels compile and run only on the card)")
    return torch.device("cuda", 0)


def _rand(shape, device, seed=0, full_range=False):
    hi = 2**64 - 1 if full_range else gl.P - 1
    x = np.random.default_rng(seed).integers(0, hi, size=shape, dtype=np.uint64, endpoint=True)
    return tensor_from_u64(x, device)


@pytest.mark.parametrize("shape", [(1, 781), (300, 781), (1000, 8), (7, 13), (3, 0)])
def test_k1_hash_leaves(card, shape):
    x = _rand(shape, card, full_range=True)
    before = kernels.LAUNCHES["K1"]
    got = poseidon_cuda.hash_leaves(x)
    assert kernels.LAUNCHES["K1"] == before + 1
    assert torch.equal(got, poseidon_cuda.hash_leaves_plain(x))


EDGE_WORDS = [0, 1, 2, gl.P - 2, gl.P - 1, gl.P, gl.P + 1, 2**64 - 2, 2**64 - 1,
              2**32 - 1, 2**32, 2**63, 0xFFFFFFFF00000000, 0xFFFFFFFE00000001]


def test_k1_k2_edge_words(card):
    """Every pair of carry and borrow edge words through the carry-chain
    arithmetic of csrc/goldilocks.cuh, as states and as leaves."""
    edge = np.array(EDGE_WORDS, dtype=np.uint64)
    pairs = np.stack(np.meshgrid(edge, edge), -1).reshape(-1, 2)
    states = tensor_from_u64(np.tile(pairs, (1, 6)), card)
    assert torch.equal(poseidon_cuda.permute_states(states), poseidon_cuda.permute_states_plain(states))
    leaves = tensor_from_u64(np.tile(pairs, (1, 5))[:, :9], card)
    assert torch.equal(poseidon_cuda.hash_leaves(leaves), poseidon_cuda.hash_leaves_plain(leaves))


@pytest.mark.parametrize("n", [1, 129, 4096])
def test_k2_permute_states(card, n):
    x = _rand((n, 12), card, full_range=True)
    assert torch.equal(poseidon_cuda.permute_states(x), poseidon_cuda.permute_states_plain(x))


# Every split of the two-pass plan and the one-pass/two-pass boundary (2^10 /
# 2^11), at widths 1, 7 and 781 while the plain version fits on the card.
NTT_SHAPES = [(1, 1), (5, 8), (8192, 16), (13, 1 << 12), (3, 1 << 13), (2, 1 << 15)] + [
    (w, 1 << k) for k in (10, 11, 12, 13, 16, 17, 20) for w in (1, 7, 781) if w << k <= 781 << 16
]


@pytest.mark.parametrize("shape", NTT_SHAPES)
def test_k3_ntt_intt(card, shape):
    x = _rand(shape, card)
    assert torch.equal(ntt_cuda.ntt(x), ntt_cuda.ntt_plain(x))
    assert torch.equal(ntt_cuda.intt(x), ntt_cuda.intt_plain(x))


def test_k3_size_one_keeps_non_canonical_words(card):
    x = tensor_from_u64(np.array([[2**64 - 1], [gl.P], [5]], dtype=np.uint64), card)
    assert torch.equal(ntt_cuda.ntt(x), x)
    assert torch.equal(ntt_cuda.intt(x), x)


def test_k3_two_pass_counts_one_launch(card):
    x = _rand((3, 1 << 16), card)
    before = kernels.LAUNCHES["K3"]
    ntt_cuda.intt(x)
    assert kernels.LAUNCHES["K3"] == before + 1


LDE_SHAPES = [((1, 1), 1), ((5, 8), 1), ((7, 1 << 11), 1), ((3, 1 << 12), 2)] + [
    ((w, 1 << k), rate) for k in (9, 10, 11, 12, 15, 16, 18) for w in (1, 7, 781)
    for rate in (1, 2) if w << (k + rate) <= 781 << 17
]


@pytest.mark.parametrize("shape,rate", LDE_SHAPES)
def test_k4_coset_lde(card, shape, rate):
    x = _rand(shape, card)
    assert torch.equal(ntt_cuda.coset_lde(x, rate), ntt_cuda.coset_lde_plain(x, rate))


def test_wrappers_reject_non_contiguous(card):
    x = _rand((16, 32), card)
    with pytest.raises(ValueError):
        ntt_cuda.ntt(x.T)
    with pytest.raises(ValueError):
        poseidon_cuda.hash_leaves(x.T)


def test_demo_proof_on_card_equals_cpu(card):
    from plonky2_bn254_tpu_torch.prover import prove as prove_mod
    from plonky2_bn254_tpu_torch.prover.config import TEST_CONFIG
    from plonky2_bn254_tpu_torch.starks.demo import demo_stark, demo_trace

    trace, ctl = demo_trace(np.random.default_rng(3))
    kernels.reset_launches()
    on_card = proof_to_fields(prove_mod.prove(demo_stark(), trace.to(card), ctl, TEST_CONFIG))
    assert all(kernels.LAUNCHES[k] > 0 for k in kernels.KERNEL_IDS)
    on_cpu = proof_to_fields(prove_mod.prove(demo_stark(), trace, ctl, TEST_CONFIG))
    as_json = lambda f: json.dumps(f, default=lambda v: v.tolist())
    assert as_json(on_card) == as_json(on_cpu)
