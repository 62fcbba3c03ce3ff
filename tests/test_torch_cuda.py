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


@pytest.mark.parametrize("n", [1, 129, 4096])
def test_k2_permute_states(card, n):
    x = _rand((n, 12), card, full_range=True)
    assert torch.equal(poseidon_cuda.permute_states(x), poseidon_cuda.permute_states_plain(x))


@pytest.mark.parametrize("shape", [(1, 1), (5, 8), (8192, 16), (13, 1 << 12), (3, 1 << 13), (2, 1 << 15)])
def test_k3_ntt_intt(card, shape):
    x = _rand(shape, card)
    assert torch.equal(ntt_cuda.ntt(x), ntt_cuda.ntt_plain(x))
    assert torch.equal(ntt_cuda.intt(x), ntt_cuda.intt_plain(x))


@pytest.mark.parametrize("shape,rate", [((1, 1), 1), ((5, 8), 1), ((7, 1 << 11), 1), ((3, 1 << 12), 2)])
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
