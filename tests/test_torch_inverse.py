"""K6's schedule (`field/inv_cuda.py`) on the CPU: the emulation of the
kernel's tiles, runs, shuffle scans and Fermat chain against the plain
`goldilocks.batch_inv`, the wrapper's plain path on a CPU tensor, the
prover's batch inversions all routed through the wrapper, and K6's bound.
The kernel itself runs only on the card (tests/test_torch_cuda.py -k k6)."""

import pathlib
import sys

import numpy as np
import pytest
import torch

from plonky2_bn254_tpu_torch import bounds, kernels
from plonky2_bn254_tpu_torch.field import goldilocks as gl
from plonky2_bn254_tpu_torch.field import inv_cuda
from plonky2_bn254_tpu_torch.interop import tensor_from_u64, u64_from_tensor

B = inv_cuda.BLOCK
# ragged sizes: none, one, across a warp's runs, a tile's edges, several tiles
SIZES = [0, 1, 2, 31, inv_cuda.THREADS, B - 1, B, B + 1, 2 * B + 257, 10007]


def _residues(n: int, seed: int) -> torch.Tensor:
    """Random residues with zeros every 97 elements and at run and tile edges."""
    x = np.random.default_rng(seed).integers(0, gl.P, size=n, dtype=np.uint64)
    if n:
        edges = [0, inv_cuda.THREADS - 1, inv_cuda.THREADS, B - 1, B, n - 1]
        x[[e for e in edges if e < n] + list(range(3, n, 97))] = 0
    return tensor_from_u64(x)


@pytest.mark.parametrize("n", SIZES)
def test_emulation_equals_the_plain_inverse(n):
    x = _residues(n, seed=n)
    assert torch.equal(inv_cuda.emulate(x), gl.batch_inv(x))


@pytest.mark.parametrize("shape", [(3, 1000), (2, 3, B // 2 + 1)])
def test_emulation_takes_any_shape_as_one_vector(shape):
    x = _residues(int(np.prod(shape)), seed=7).reshape(shape)
    got = inv_cuda.emulate(x)
    assert got.shape == x.shape
    assert torch.equal(got.reshape(-1), gl.batch_inv(x.reshape(-1)))


def test_emulation_reduces_words_at_or_above_p():
    words = [0, 1, gl.P - 1, gl.P, gl.P + 1, gl.P + 2, 2**64 - 1, 2**63, 2**32]
    got = u64_from_tensor(inv_cuda.emulate(tensor_from_u64(np.array(words, dtype=np.uint64))))
    assert [int(v) for v in got] == [gl.h_inv(w % gl.P) for w in words]


def test_fermat_chain_is_the_inverse():
    x = np.random.default_rng(3).integers(1, gl.P, size=64, dtype=np.uint64)
    got = u64_from_tensor(inv_cuda.fermat_inverse(tensor_from_u64(x)))
    assert [int(v) for v in got] == [gl.h_inv(int(v)) for v in x]
    # e_k = x^(2^k - 1) doubled up to p - 2: 64 squarings and 9 products
    assert (2**31 - 1) * 2**33 + (2**32 - 1) == gl.P - 2


@pytest.mark.parametrize("n", [0, 5, B + 3])
def test_cpu_tensor_takes_the_plain_path(n, monkeypatch):
    calls = []
    plain = gl.batch_inv
    monkeypatch.setattr(gl, "batch_inv", lambda x: calls.append(x.shape) or plain(x))
    x = _residues(n, seed=11)
    before = kernels.LAUNCHES["K6"]
    assert torch.equal(inv_cuda.batch_inv(x), plain(x))
    assert calls == [x.shape]
    assert kernels.LAUNCHES["K6"] == before


def test_wrapper_refuses_a_device_with_no_path():
    with pytest.raises(ValueError):
        inv_cuda.batch_inv(torch.ones(4, dtype=torch.int64, device="meta"))


@pytest.mark.parametrize("machine", ["demo", "keyed_demo"])
@pytest.mark.parametrize("device_fs", [False, True])
def test_every_inversion_of_a_proof_goes_through_the_wrapper(machine, device_fs, monkeypatch):
    """The prover's batch inversions are all `inv_cuda.batch_inv` calls, as
    many as chip_smoke.k6_per_proof counts (three more the first time the
    domain's selectors are made), so on the card each is one K6 launch."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import chip_smoke
    from plonky2_bn254_tpu_torch.prover import prove as prove_mod
    from plonky2_bn254_tpu_torch.prover.config import TEST_CONFIG
    from plonky2_bn254_tpu_torch.starks import demo

    mk_stark, mk_trace = {"demo": (demo.demo_stark, demo.demo_trace),
                          "keyed_demo": (demo.keyed_demo_stark, demo.keyed_demo_trace)}[machine]
    stark = mk_stark()
    trace, ctl = mk_trace(np.random.default_rng(4))
    calls, routed = [], inv_cuda.batch_inv
    monkeypatch.setattr(inv_cuda, "batch_inv", lambda x: calls.append(x.numel()) or routed(x))
    domains = prove_mod._domain_arrays.cache_info().misses
    prove_mod.prove(stark, trace, ctl, TEST_CONFIG, device_fs=device_fs)
    new_domains = prove_mod._domain_arrays.cache_info().misses - domains
    want = chip_smoke.k6_per_proof(stark, TEST_CONFIG.num_challenges, device_fs)
    assert len(calls) == want + 3 * new_domains
    assert all(n > 0 for n in calls)


def test_bound_counts_three_products_an_element_and_one_chain():
    ops, nbytes, chain = bounds.batch_inv_work(900 << 16)
    n = 900 << 16
    assert ops == (3 * (n - 1) + bounds.FERMAT_PRODUCTS) * bounds.OP_COST["mul"]
    assert nbytes == 16 * n
    assert chain == bounds.FERMAT_PRODUCTS * bounds.OP_LATENCY["mul"]
    assert bounds.bound_ms(ops, nbytes, 132, 1980.0, chain)[1] == "bytes"
    # a lone element waits on the Fermat chain
    ops, nbytes, chain = bounds.batch_inv_work(1)
    ms, by = bounds.bound_ms(ops, nbytes, 132, 1980.0, chain)
    assert by == "operations" and ms == pytest.approx(73 * 101 / 1980e3)
    assert bounds.batch_inv_work(0) == (0, 0, 0)
