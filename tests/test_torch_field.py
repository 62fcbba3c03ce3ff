"""Goldilocks and GF(p^2) arithmetic of the PyTorch port against the JAX package.

Inputs come from numpy and go through both packages; integer results are
compared exactly, bit pattern for bit pattern, including edge values and
non-canonical inputs (p, 2^64 - 1) where the JAX functions accept them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plonky2_bn254_tpu.field import extension as jext
from plonky2_bn254_tpu.field import goldilocks as jgl
from plonky2_bn254_tpu_torch.field import extension as text
from plonky2_bn254_tpu_torch.field import goldilocks as gl
from plonky2_bn254_tpu_torch.interop import tensor_from_u64, u64_from_tensor

torch.set_num_threads(2)

P = gl.P
EDGE = np.array(
    [0, 1, 2, P - 1, P - 2, P, P + 1, 2**64 - 1, 2**63, 2**32, 2**32 - 1, 2**32 + 1],
    dtype=np.uint64,
)


def _operands(seed, canonical=False):
    rng = np.random.default_rng(seed)
    hi = P - 1 if canonical else 2**64 - 1
    edge = EDGE[EDGE <= hi]
    a = np.concatenate([rng.integers(0, hi, 500, dtype=np.uint64, endpoint=True),
                        np.repeat(edge, len(edge))])
    b = np.concatenate([rng.integers(0, hi, 500, dtype=np.uint64, endpoint=True),
                        np.tile(edge, len(edge))])
    return a, b


def _t(x):
    return tensor_from_u64(x)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match_jax(op):
    a, b = _operands(1)
    want = np.asarray(getattr(jgl, op)(jnp.asarray(a), jnp.asarray(b)))
    got = u64_from_tensor(getattr(gl, op)(_t(a), _t(b)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["neg", "square", "inv"])
def test_unary_ops_match_jax(op):
    a, _ = _operands(2)
    want = np.asarray(getattr(jgl, op)(jnp.asarray(a)))
    got = u64_from_tensor(getattr(gl, op)(_t(a)))
    np.testing.assert_array_equal(got, want)


def test_scalar_operands_match_jax():
    a, _ = _operands(3)
    for c in [0, 1, 7, P - 1, 2**40 + 3]:
        want = np.asarray(jgl.mul_const(jnp.asarray(a), c))
        np.testing.assert_array_equal(u64_from_tensor(gl.mul_const(_t(a), c)), want)
        want = np.asarray(jgl.add(jnp.asarray(a), jnp.uint64(c)))
        np.testing.assert_array_equal(u64_from_tensor(gl.add(_t(a), c)), want)
        want = np.asarray(jgl.sub(jnp.asarray(a), jnp.uint64(c)))
        np.testing.assert_array_equal(u64_from_tensor(gl.sub(_t(a), c)), want)


def test_exp_const_matches_jax():
    a, _ = _operands(4, canonical=True)
    for e in [0, 1, 2, 7, 2**32 + 5, P - 2]:
        want = np.asarray(jgl.exp_const(jnp.asarray(a), e))
        np.testing.assert_array_equal(u64_from_tensor(gl.exp_const(_t(a), e)), want)


@pytest.mark.parametrize("size", [1000, 5000])
def test_batch_inv_matches_jax(size):
    """5000 > 4 * 1024 takes the chunked prefix-product path."""
    x = np.random.default_rng(size).integers(0, P, size, dtype=np.uint64)
    x[::97] = 0
    want = np.asarray(jgl.batch_inv(jnp.asarray(x)))
    np.testing.assert_array_equal(u64_from_tensor(gl.batch_inv(_t(x))), want)


def test_host_helpers_and_subgroup():
    assert gl.POWER_OF_TWO_GENERATOR == jgl.POWER_OF_TWO_GENERATOR
    for k in [0, 1, 5, 10]:
        assert gl.primitive_root_of_unity(k) == jgl.primitive_root_of_unity(k)
        np.testing.assert_array_equal(gl.two_adic_subgroup(k), jgl.two_adic_subgroup(k))
    for a in [0, 1, 12345, P - 1]:
        assert gl.h_inv(a) == jgl.h_inv(a)
        assert gl.h_mul(a, 99) == jgl.h_mul(a, 99)
        assert gl.h_add(a, P - 3) == jgl.h_add(a, P - 3)
        assert gl.h_sub(a, 12346) == jgl.h_sub(a, 12346)
        assert gl.h_exp(a, 12345) == jgl.h_exp(a, 12345)


def test_ext_tensor_ops_match_jax():
    rng = np.random.default_rng(6)
    a0, a1, b0, b1 = (rng.integers(0, P, 200, dtype=np.uint64) for _ in range(4))
    ja, jb = jext.Ext(jnp.asarray(a0), jnp.asarray(a1)), jext.Ext(jnp.asarray(b0), jnp.asarray(b1))
    ta, tb = text.Ext(_t(a0), _t(a1)), text.Ext(_t(b0), _t(b1))
    for j, t in [(ja + jb, ta + tb), (ja - jb, ta - tb), (ja * jb, ta * tb), (ja.inv(), ta.inv()),
                 (ja.neg(), ta.neg()), (ja.scalar_mul(jnp.asarray(b0)), ta.scalar_mul(_t(b0)))]:
        np.testing.assert_array_equal(u64_from_tensor(t.c0), np.asarray(j.c0))
        np.testing.assert_array_equal(u64_from_tensor(t.c1), np.asarray(j.c1))


def test_glext_host_matches_jax():
    rng = np.random.default_rng(7)
    for _ in range(20):
        a, b, c, d = (int(v) for v in rng.integers(0, P, 4, dtype=np.uint64))
        x, y = text.GLExt(a, b), text.GLExt(c, d)
        jx, jy = jext.GLExt(a, b), jext.GLExt(c, d)
        for t, j in [(x * y, jx * jy), (x + y, jx + jy), (x - y, jx - jy), (x.inv(), jx.inv()),
                     (x.exp(12345), jx.exp(12345)), (x.frobenius(), jx.frobenius())]:
            assert (t.c0, t.c1) == (j.c0, j.c1)
