"""G1 scalar-mul machine of the PyTorch port against the JAX package.

The trace at 4 ops and min_rows=2048 (the shape of tests/test_g1.py) must be
bit-identical to JAX `generate_trace`, and the CTL values equal; the limb
arithmetic underneath and the constraint evaluation (GL ring on tensors,
both its stacked and its generic path) are held against their JAX
counterparts on random inputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plonky2_bn254_tpu.bn254 import oracle as joracle
from plonky2_bn254_tpu.starks import bigint as jbig
from plonky2_bn254_tpu.starks import g1_scalar_mul as jg1
from plonky2_bn254_tpu.starks.table import g1_scalar_mul_stark as jstark
from plonky2_bn254_tpu_torch.bn254 import oracle
from plonky2_bn254_tpu_torch.bn254.params import P as BN_P
from plonky2_bn254_tpu_torch.interop import u64_from_tensor
from plonky2_bn254_tpu_torch.starks import bigint, g1_scalar_mul
from plonky2_bn254_tpu_torch.starks.limbs import from_ints, h_int_to_limbs, h_limbs_to_int
from plonky2_bn254_tpu_torch.starks.table import g1_scalar_mul_stark
from torch_constraint_case import jax_case, port_accs

torch.set_num_threads(2)


def _inputs(n_ops, seed=5):
    rng = np.random.default_rng(seed)
    return [
        (int(rng.integers(1, 1 << 63)) << 180 | int(rng.integers(0, 1 << 63)),
         oracle.random_g1(rng), oracle.random_g1(rng), t)
        for t in range(n_ops)
    ]


def test_trace_bit_identical_to_jax():
    inputs = _inputs(4)
    got = g1_scalar_mul.generate_trace(inputs, min_rows=2048, device="cpu")
    assert got.shape == (2048, 781) and got.dtype == torch.int64
    want = np.asarray(jg1.generate_trace(inputs, min_rows=2048))
    np.testing.assert_array_equal(u64_from_tensor(got), want)
    # each op's last row holds s * x + offset
    sx = g1_scalar_mul.LAYOUT.range("sum", "x")
    for op, (s, x, offset, _) in enumerate(inputs):
        last = got[op * 512 + 511, sx.start : sx.stop].tolist()
        assert h_limbs_to_int(last) == oracle.g1_add(oracle.g1_mul(x, s), offset)[0]


def test_trace_defaults_to_the_card():
    """Without `device`, generate_trace builds on CUDA: with no card it
    raises, as torch does, rather than building on the CPU."""
    inputs = _inputs(1)
    if torch.cuda.is_available():
        assert g1_scalar_mul.generate_trace(inputs).device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError)):
        g1_scalar_mul.generate_trace(inputs)


def test_ctl_values_and_oracle_match_jax():
    inputs = _inputs(3, seed=8)
    assert g1_scalar_mul.generate_ctl_values(inputs) == jg1.generate_ctl_values(inputs)
    rng_a, rng_b = np.random.default_rng(1), np.random.default_rng(1)
    assert [oracle.random_g1(rng_a) for _ in range(4)] == [joracle.random_g1(rng_b) for _ in range(4)]


def _rand_limbs(rng, k):
    vals = [int(rng.integers(0, 2**63)) * int(rng.integers(0, 2**63)) * 2**130 % BN_P
            for _ in range(k)]
    vals[:3] = [0, 1, BN_P - 1]
    return np.array([h_int_to_limbs(v) for v in vals], dtype=np.int64)


def test_layout_lookups_and_ctls_match_jax():
    """What the shared scalar-mul machine derives for G1 (layout, range-check
    columns, lookup and CTL specs) equals the JAX package's."""
    assert (g1_scalar_mul.LAYOUT.width, g1_scalar_mul.LAYOUT.offsets) == (
        jg1.LAYOUT.width, jg1.LAYOUT.offsets)
    assert g1_scalar_mul.RANGE_CHECK_COLS == jg1.RANGE_CHECK_COLS
    assert (g1_scalar_mul.FREQ_COL, g1_scalar_mul.RANGE_COUNTER_COL) == (
        jg1.FREQ_COL, jg1.RANGE_COUNTER_COL)
    assert [vars(x) for x in g1_scalar_mul.lookups()] == [vars(x) for x in jg1.lookups()]
    assert [vars(x) for x in g1_scalar_mul.ctls()] == [vars(x) for x in jg1.ctls()]


def test_limb_arithmetic_matches_jax():
    rng = np.random.default_rng(0)
    c = rng.integers(-2**40, 2**40, (40, 31))
    c[0], c[1], c[2] = 0, -1, 65535  # carry chains through every limb
    for n in (18, 32, 49):
        np.testing.assert_array_equal(
            bigint.carry_prop(torch.from_numpy(c), n).numpy(),
            np.asarray(jbig.carry_prop(jnp.asarray(c), n)),
        )
    a, b = _rand_limbs(rng, 30), _rand_limbs(rng, 30)
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    for t, j in [(bigint.mulmod(ta, tb), jbig.mulmod(ja, jb)),
                 (bigint.mod_p(bigint.mul_full(ta, tb)), jbig.mod_p(jbig.mul_full(ja, jb))),
                 (bigint.reduce_small(7 * ta), jbig.mod_p(jbig.carry_prop(7 * ja, 32))),
                 (bigint.batch_inv_mod_p(ta), jbig.batch_inv_mod_p(ja))]:
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # exact division of multiples of p, both signs
    q = rng.integers(-2**15, 2**15, (30, 15))
    prod = np.zeros((30, 31), dtype=np.int64)
    for i in range(30):
        prod[i, :30] = np.convolve(q[i], np.array(h_int_to_limbs(BN_P)))
    t_pos, t_abs = bigint.exact_div_p(torch.from_numpy(prod))
    j_pos, j_abs = jbig.exact_div_p(jnp.asarray(prod))
    np.testing.assert_array_equal(t_pos.numpy(), np.asarray(j_pos))
    np.testing.assert_array_equal(t_abs.numpy(), np.asarray(j_abs))
    np.testing.assert_array_equal(from_ints([5, BN_P - 1]).numpy(), [h_int_to_limbs(5), h_int_to_limbs(BN_P - 1)])


@pytest.fixture(scope="module")
def constraint_case():
    """Random row values, challenges and selectors for the G1 constraint
    system, and the JAX GL ring's accumulators (stacked path) on them."""
    return jax_case(jstark(), g1_scalar_mul_stark(), seed=3)


@pytest.mark.parametrize("stacked", [True, False])
def test_constraint_evaluation_matches_jax(constraint_case, stacked):
    """All 1579 G1 constraints (AIR, LogUp, CTL) alpha-combined over random
    row values: the port's GL ring, on its stacked and its generic path,
    against the JAX GL ring."""
    count, accs = port_accs(constraint_case, g1_scalar_mul_stark(), stacked)
    assert count == constraint_case["count"]
    np.testing.assert_array_equal(accs, constraint_case["want"])
