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
from plonky2_bn254_tpu.field import goldilocks as jgl
from plonky2_bn254_tpu.prover import constraints as jcons
from plonky2_bn254_tpu.starks import air as jair
from plonky2_bn254_tpu.starks import bigint as jbig
from plonky2_bn254_tpu.starks import g1_scalar_mul as jg1
from plonky2_bn254_tpu.starks.table import g1_scalar_mul_stark as jstark
from plonky2_bn254_tpu_torch.bn254 import oracle
from plonky2_bn254_tpu_torch.bn254.params import P as BN_P
from plonky2_bn254_tpu_torch.interop import tensor_from_u64, u64_from_tensor
from plonky2_bn254_tpu_torch.prover import constraints as tcons
from plonky2_bn254_tpu_torch.starks import air as tair
from plonky2_bn254_tpu_torch.starks import bigint, g1_scalar_mul
from plonky2_bn254_tpu_torch.starks.limbs import from_ints, h_int_to_limbs, h_limbs_to_int
from plonky2_bn254_tpu_torch.starks.table import g1_scalar_mul_stark

torch.set_num_threads(2)

GL_P = jgl.P


def _inputs(n_ops, seed=5):
    rng = np.random.default_rng(seed)
    return [
        (int(rng.integers(1, 1 << 63)) << 180 | int(rng.integers(0, 1 << 63)),
         oracle.random_g1(rng), oracle.random_g1(rng), t)
        for t in range(n_ops)
    ]


def test_trace_bit_identical_to_jax():
    inputs = _inputs(4)
    got = g1_scalar_mul.generate_trace(inputs, min_rows=2048)
    assert got.shape == (2048, 781) and got.dtype == torch.int64
    want = np.asarray(jg1.generate_trace(inputs, min_rows=2048))
    np.testing.assert_array_equal(u64_from_tensor(got), want)
    # each op's last row holds s * x + offset
    sx = g1_scalar_mul.LAYOUT.range("sum", "x")
    for op, (s, x, offset, _) in enumerate(inputs):
        last = got[op * 512 + 511, sx.start : sx.stop].tolist()
        assert h_limbs_to_int(last) == oracle.g1_add(oracle.g1_mul(x, s), offset)[0]


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
    rng = np.random.default_rng(3)
    C, W = 8, 781
    sj = jstark()
    aw = tcons.aux_width(g1_scalar_mul_stark(), 2)
    case = {
        "vals": {k: rng.integers(0, GL_P, (n, C), dtype=np.uint64)
                 for k, n in [("loc", W), ("nxt", W), ("aloc", aw), ("anxt", aw)]},
        "sel": rng.integers(0, GL_P, (3, C), dtype=np.uint64),
        "alphas": [int(x) for x in rng.integers(0, GL_P, 2, dtype=np.uint64)],
        "challenges": [tuple(int(x) for x in rng.integers(0, GL_P, 2, dtype=np.uint64))
                       for _ in range(2)],
        "totals": [[int(x) for x in rng.integers(0, GL_P, 2, dtype=np.uint64)] for _ in range(2)],
    }
    case["alpha_pows"] = np.array([[pow(a, j, GL_P) for j in range(513)] for a in case["alphas"]],
                                  dtype=np.uint64)
    case["static"] = tuple(tuple(c for c, _ in ctl.flat_weights(1, GL_P)) for ctl in sj.ctls)

    ring = jair.GLRing((C,))
    lj = {k: [jair.GL(jnp.asarray(v[j])) for j in range(v.shape[0])]
          for k, v in case["vals"].items()}
    cj = jair.ConstraintConsumer(ring, [ring.const(jnp.uint64(a)) for a in case["alphas"]],
                                 *(jair.GL(jnp.asarray(s)) for s in case["sel"]),
                                 alpha_pows=jnp.asarray(case["alpha_pows"]))
    wj = [[jnp.asarray(np.array([w for _, w in ctl.flat_weights(b, GL_P)], dtype=np.uint64))
           for ctl in sj.ctls] for b, _ in case["challenges"]]
    jcons.eval_all_constraints(
        cj, ring, sj, lj["loc"], lj["nxt"], lj["aloc"], lj["anxt"],
        [(jnp.uint64(b), jnp.uint64(g)) for b, g in case["challenges"]],
        [[jnp.uint64(x) for x in r] for r in case["totals"]],
        ctl_weight_specs=(case["static"], wj),
    )
    case["count"] = cj.count
    case["want"] = np.stack([np.asarray(a.v) for a in cj.accs])
    return case


@pytest.mark.parametrize("stacked", [True, False])
def test_constraint_evaluation_matches_jax(constraint_case, stacked):
    """All 1579 G1 constraints (AIR, LogUp, CTL) alpha-combined over random
    row values: the port's GL ring, on its stacked and its generic path,
    against the JAX GL ring."""
    case = constraint_case
    st = g1_scalar_mul_stark()
    C = case["sel"].shape[1]
    tring = tair.GLRing((C,), "cpu")
    lt = {k: [tair.GL(tensor_from_u64(v[j])) for j in range(v.shape[0])]
          for k, v in case["vals"].items()}
    ct = tair.ConstraintConsumer(
        tring, [tring.const(a) for a in case["alphas"]],
        *(tair.GL(tensor_from_u64(s)) for s in case["sel"]),
        alpha_pows=tensor_from_u64(case["alpha_pows"]) if stacked else None,
    )
    specs = None
    if stacked:
        wt = [[tensor_from_u64(np.array([w for _, w in ctl.flat_weights(b, GL_P)], dtype=np.uint64))
               for ctl in st.ctls] for b, _ in case["challenges"]]
        specs = (case["static"], wt)
    tcons.eval_all_constraints(ct, tring, st, lt["loc"], lt["nxt"], lt["aloc"], lt["anxt"],
                               case["challenges"], case["totals"], ctl_weight_specs=specs)
    assert ct.count == case["count"]
    np.testing.assert_array_equal(np.stack([u64_from_tensor(a.v) for a in ct.accs]), case["want"])
