"""NTT / coset LDE of the PyTorch port against the JAX package.

The plain versions of kernels K3 (NTT / iNTT) and K4 (coset LDE) — what the
wrappers in `field/ntt_cuda.py` run for a CPU tensor — are held against the
Pallas kernels in interpret mode at n = 2^14 (as tests/test_ntt_pallas.py
runs them) and against `field/ntt.py` for n = 2^1 .. 2^12 and widths that
are not multiples of 8.
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


def test_inverse_matches_pallas_interpret():
    x = _x(2, 1 << 14)
    want = np.asarray(ntt_pallas.intt(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(u64_from_tensor(ntt_cuda.intt(tensor_from_u64(x))), want)


def test_coset_lde_matches_pallas_interpret():
    x = _x(3, 1 << 13)
    want = np.asarray(ntt_pallas.coset_lde_rate1(jnp.asarray(x), interpret=True))
    got = u64_from_tensor(ntt_cuda.coset_lde(tensor_from_u64(x), 1))
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


def test_wrappers_reject_bad_sizes():
    with pytest.raises(ValueError):
        ntt_cuda._log2(12, "ntt")
