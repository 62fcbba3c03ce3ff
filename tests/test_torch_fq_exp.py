"""FqExp machine of the PyTorch port against the JAX package.

The trace at 2 ops and min_rows=2048 (the shape of tests/test_fq_exp_trace.py)
must be bit-identical to JAX `generate_trace`, each op's product column must
hold x^s, and the CTL values, the limb arithmetic underneath (addmod,
submod, the fq_mul witness) and the constraint evaluation (GL ring on
tensors, stacked and generic paths) must equal their JAX counterparts.  The
tolerance is zero throughout: the arithmetic is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plonky2_bn254_tpu.starks import bigint as jbig
from plonky2_bn254_tpu.starks import fq_exp as jfq_exp
from plonky2_bn254_tpu.starks import fq_mul as jfq_mul
from plonky2_bn254_tpu.starks.table import fq_exp_stark as jstark
from plonky2_bn254_tpu_torch.bn254 import oracle
from plonky2_bn254_tpu_torch.bn254.params import P as BN_P
from plonky2_bn254_tpu_torch.interop import u64_from_tensor
from plonky2_bn254_tpu_torch.starks import bigint, fq_exp, fq_mul
from plonky2_bn254_tpu_torch.starks.limbs import h_int_to_limbs, h_limbs_to_int
from plonky2_bn254_tpu_torch.starks.table import fq_exp_stark
from torch_constraint_case import jax_case, port_accs

torch.set_num_threads(2)


def _inputs(n_ops, seed=3):
    rng = np.random.default_rng(seed)
    return [
        (int(rng.integers(0, 1 << 63)) << 193 | int(rng.integers(0, 1 << 63)),
         oracle.random_fq(rng), t)
        for t in range(n_ops)
    ]


def _residues(rng, k):
    vals = [oracle.random_fq(rng) for _ in range(k)]
    vals[:3] = [0, 1, BN_P - 1]
    return np.array([h_int_to_limbs(v) for v in vals], dtype=np.int64)


def test_addmod_submod_match_jax():
    rng = np.random.default_rng(0)
    a, b = _residues(rng, 24), _residues(rng, 24)
    b[3:6] = a[:3]  # 0 + 0, 1 - 1, (p - 1) + (p - 1) among the pairs
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    for got, want in [(bigint.addmod(ta, tb), jbig.addmod(ja, jb)),
                      (bigint.submod(ta, tb), jbig.submod(ja, jb)),
                      (bigint.submod(tb, ta), jbig.submod(jb, ja))]:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    sums = bigint.addmod(ta, tb)
    for i in range(24):
        x, y = h_limbs_to_int(a[i]), h_limbs_to_int(b[i])
        assert h_limbs_to_int(sums[i].tolist()) == bigint.h_mod_p(x + y)
    assert bigint.h_mod_p(-1) == jbig.h_mod_p(-1) == BN_P - 1


def test_fq_mul_witness_matches_jax():
    rng = np.random.default_rng(1)
    a, b = _residues(rng, 20), _residues(rng, 20)
    c, aux = fq_mul.generate_fq_mul(torch.from_numpy(a), torch.from_numpy(b))
    jc, jaux = jfq_mul.generate_fq_mul(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    for got, want in zip(aux, jaux):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_trace_bit_identical_to_jax():
    inputs = _inputs(2)
    got = fq_exp.generate_trace(inputs, min_rows=2048, device="cpu")
    assert got.shape == (2048, 427) and got.dtype == torch.int64
    want = np.asarray(jfq_exp.generate_trace(inputs, min_rows=2048))
    np.testing.assert_array_equal(u64_from_tensor(got), want)
    # each op's product column holds x^s on its last row
    prod = fq_exp.LAYOUT.range("product")
    for op, (s, x, _) in enumerate(inputs):
        last = got[op * 512 + 511, prod.start : prod.stop].tolist()
        assert h_limbs_to_int(last) == pow(x, s, BN_P)


def test_layout_matches_jax():
    assert (fq_exp.LAYOUT.width, fq_exp.LAYOUT.offsets) == (427, jfq_exp.LAYOUT.offsets)
    assert fq_exp.RANGE_CHECK_COLS == jfq_exp.RANGE_CHECK_COLS


def test_trace_defaults_to_the_card():
    """Without `device`, generate_trace builds on CUDA: with no card it
    raises, as torch does, rather than building on the CPU."""
    inputs = _inputs(1)
    if torch.cuda.is_available():
        assert fq_exp.generate_trace(inputs).device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError)):
        fq_exp.generate_trace(inputs)


def test_ctl_values_match_jax():
    inputs = _inputs(3, seed=8)
    assert fq_exp.generate_ctl_values(inputs) == jfq_exp.generate_ctl_values(inputs)


@pytest.fixture(scope="module")
def constraint_case():
    return jax_case(jstark(), fq_exp_stark(), seed=4)


@pytest.mark.parametrize("stacked", [True, False])
def test_constraint_evaluation_matches_jax(constraint_case, stacked):
    """Every FqExp constraint (AIR, LogUp, CTL) alpha-combined over random
    row values: the port's GL ring, stacked and generic, against JAX's."""
    count, accs = port_accs(constraint_case, fq_exp_stark(), stacked)
    assert count == constraint_case["count"]
    np.testing.assert_array_equal(accs, constraint_case["want"])


@pytest.mark.slow
def test_fq_exp_proof_equals_jax_field_by_field():
    """FqExp at 2 ops and 2048 rows under TEST_CONFIG.  Fewer than 2^16 rows
    cannot satisfy the range-counter constraint, so neither proof verifies;
    the two provers must agree bit for bit."""
    from plonky2_bn254_tpu.prover import prove as jprove
    from plonky2_bn254_tpu.prover.config import TEST_CONFIG as JTEST_CONFIG
    from plonky2_bn254_tpu_torch.interop import proof_to_fields
    from plonky2_bn254_tpu_torch.prover import prove as prove_mod
    from plonky2_bn254_tpu_torch.prover.config import TEST_CONFIG
    from test_torch_prove import assert_fields_equal

    inputs = _inputs(2)
    trace = fq_exp.generate_trace(inputs, min_rows=2048, device="cpu")
    ctl = fq_exp.generate_ctl_values(inputs)
    tproof = prove_mod.prove(fq_exp_stark(), trace, ctl, TEST_CONFIG)
    jproof = jprove.prove(jstark(), jnp.asarray(u64_from_tensor(trace)), ctl, JTEST_CONFIG)
    assert_fields_equal(proof_to_fields(tproof), proof_to_fields(jproof))
