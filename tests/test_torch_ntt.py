"""NTT / coset LDE of the PyTorch port against the JAX package.

The plain versions of kernels K3 (NTT / iNTT) and K4 (coset LDE) — what the
wrappers in `field/ntt_cuda.py` run for a CPU tensor — are held against the
Pallas kernels in interpret mode at n = 2^14 (as tests/test_ntt_pallas.py
runs them) and against `field/ntt.py` for n = 2^1 .. 2^12 and widths that
are not multiples of 8.  `ntt_cuda.emulate`, the kernels' two-pass plan
run in plain torch on the very tables the card reads, is held against both
(and against the plain versions) for n = 2^0 .. 2^14, with tolerance zero.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plonky2_bn254_tpu.field import goldilocks as jgl
from plonky2_bn254_tpu.field import ntt as jntt
from plonky2_bn254_tpu.field import ntt_pallas
from plonky2_bn254_tpu_torch.field import ntt, ntt_cuda
from plonky2_bn254_tpu_torch.interop import tensor_from_u64, u64_from_tensor

torch.set_num_threads(2)

RNG = np.random.default_rng(31)


def _x(w, n):
    return RNG.integers(0, jgl.P, size=(w, n), dtype=np.uint64)


def test_forward_matches_pallas_interpret():
    x = _x(3, 1 << 14)
    want = np.asarray(ntt_pallas.ntt(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(u64_from_tensor(ntt_cuda.ntt(tensor_from_u64(x))), want)
    np.testing.assert_array_equal(u64_from_tensor(ntt_cuda.emulate(tensor_from_u64(x))), want)


def test_inverse_matches_pallas_interpret():
    x = _x(2, 1 << 14)
    want = np.asarray(ntt_pallas.intt(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(u64_from_tensor(ntt_cuda.intt(tensor_from_u64(x))), want)
    got = ntt_cuda.emulate(tensor_from_u64(x), inverse=True)
    np.testing.assert_array_equal(u64_from_tensor(got), want)


def test_coset_lde_matches_pallas_interpret():
    x = _x(3, 1 << 13)
    want = np.asarray(ntt_pallas.coset_lde_rate1(jnp.asarray(x), interpret=True))
    got = u64_from_tensor(ntt_cuda.coset_lde(tensor_from_u64(x), 1))
    np.testing.assert_array_equal(got, want)
    got = u64_from_tensor(ntt_cuda.emulate(tensor_from_u64(x), rate_bits=1))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("w", [1, 5, 13])
def test_small_sizes_match_xla_ntt(w):
    """Every size from 2^1 to 2^12; rows are independent, so the JAX side
    transforms 13 rows once per size and the port each width."""
    for k in range(1, 13):
        x = np.random.default_rng(k).integers(0, jgl.P, (13, 1 << k), dtype=np.uint64)
        jx, tx = jnp.asarray(x), tensor_from_u64(x[:w])
        np.testing.assert_array_equal(u64_from_tensor(ntt_cuda.ntt(tx)), np.asarray(jntt.ntt(jx))[:w])
        np.testing.assert_array_equal(u64_from_tensor(ntt_cuda.intt(tx)), np.asarray(jntt.intt(jx))[:w])
        np.testing.assert_array_equal(
            u64_from_tensor(ntt_cuda.coset_lde(tx, 1)),
            np.asarray(jntt.coset_lde_from_coeffs(jx, 1))[:w],
        )


def test_size_one_and_rate_two():
    x = _x(4, 1)
    # n = 1 is the identity, non-canonical words included
    x[0, 0] = 2**64 - 1
    t = tensor_from_u64(x)
    np.testing.assert_array_equal(u64_from_tensor(ntt_cuda.ntt(t)), np.asarray(jntt.ntt(jnp.asarray(x))))
    np.testing.assert_array_equal(u64_from_tensor(ntt_cuda.intt(t)), np.asarray(jntt.intt(jnp.asarray(x))))
    y = _x(3, 64)
    want = np.asarray(jntt.coset_lde_from_coeffs(jnp.asarray(y), 2))
    np.testing.assert_array_equal(u64_from_tensor(ntt_cuda.coset_lde(tensor_from_u64(y), 2)), want)


def test_roundtrip_and_host_oracle():
    x = _x(2, 256)
    t = tensor_from_u64(x)
    np.testing.assert_array_equal(u64_from_tensor(ntt.intt(ntt.ntt(t))), x)
    np.testing.assert_array_equal(u64_from_tensor(ntt.ntt(t))[1], jntt.h_ntt(x[1]))
    np.testing.assert_array_equal(ntt._bit_reverse_perm(9), jntt._bit_reverse_perm(9))


@pytest.mark.parametrize("w", [1, 5, 13])
def test_two_pass_emulation_matches_xla_ntt(w):
    """The kernels' plan on its tables, n = 2^0 .. 2^14 (one pass up to
    2^10, two from 2^11): NTT, iNTT and the LDE at rates 1 and 2 equal the
    JAX package and the plain versions."""
    for k in range(0, 15):
        x = np.random.default_rng(100 + k).integers(0, jgl.P, (13, 1 << k), dtype=np.uint64)
        jx, tx = jnp.asarray(x), tensor_from_u64(x[:w])
        cases = [
            (ntt_cuda.emulate(tx), jntt.ntt(jx), ntt_cuda.ntt_plain(tx)),
            (ntt_cuda.emulate(tx, inverse=True), jntt.intt(jx), ntt_cuda.intt_plain(tx)),
        ] + [
            (ntt_cuda.emulate(tx, rate_bits=r), jntt.coset_lde_from_coeffs(jx, r),
             ntt_cuda.coset_lde_plain(tx, r))
            for r in (1, 2)
        ]
        for got, want_jax, want_plain in cases:
            assert torch.equal(got, want_plain), (k, w)
            np.testing.assert_array_equal(u64_from_tensor(got), np.asarray(want_jax)[:w])


def test_plan_fits_the_kernels():
    """Every n up to 2^22 takes at most two passes of tiles of at most 2^11
    words a line, within 512 threads and 8192 words a tile, with lines that
    divide the other factor; beyond that pass 1 keeps n1 = 2^11."""
    for n_log in range(0, 33):
        p = ntt_cuda.plan(n_log)
        assert sum(p) == n_log
        if len(p) == 1:
            assert n_log <= ntt_cuda.ONE_PASS_MAX_LOG
            log_l = ntt_cuda.lines_log(n_log, True)
            assert log_l >= 0 and (1 << (log_l + n_log - min(n_log, 4))) == 256
            continue
        m1, m2 = p
        assert m1 <= ntt_cuda.TILE_MAX_LOG and (n_log > 22 or m2 <= ntt_cuda.TILE_MAX_LOG)
        for m, other in ((m1, m2), (m2, m1)):
            if m > ntt_cuda.TILE_MAX_LOG:
                continue
            log_l = ntt_cuda.lines_log(m, False)
            assert log_l <= other and (1 << (log_l + m)) <= 8192
            assert (1 << (log_l + m - 4)) <= 512


def test_emulation_beyond_two_passes(monkeypatch):
    """Rows longer than two tiles become a transform of their own; shown
    with the tile limits lowered so the third pass comes at small n."""
    monkeypatch.setattr(ntt_cuda, "ONE_PASS_MAX_LOG", 3)
    monkeypatch.setattr(ntt_cuda, "TILE_MAX_LOG", 4)
    for k in range(9, 13):
        assert len(ntt_cuda.plan(k)) == 2 and ntt_cuda.plan(k)[1] > 4
        x = tensor_from_u64(np.random.default_rng(k).integers(0, jgl.P, (3, 1 << k), dtype=np.uint64))
        assert torch.equal(ntt_cuda.emulate(x, inverse=True), ntt_cuda.intt_plain(x))
        assert torch.equal(ntt_cuda.emulate(x, rate_bits=1), ntt_cuda.coset_lde_plain(x, 1))


def test_wrappers_reject_bad_sizes():
    with pytest.raises(ValueError):
        ntt_cuda._log2(12, "ntt")
