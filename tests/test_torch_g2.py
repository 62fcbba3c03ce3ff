"""G2 scalar-mul machine of the PyTorch port against the JAX package and the
oracle.

The JAX G2 witness executables take minutes to compile on the CPU (the JAX
package's own tests mark them slow), so tier-1 holds the port against the
JAX Fq2 functions that do run fast, against the Python oracle, and against
the JAX GL ring's constraint accumulators; the slow tier compares the whole
trace and the prover with JAX.  The tolerance is zero throughout.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plonky2_bn254_tpu.starks import fq2_alg as jfq2
from plonky2_bn254_tpu.starks import g2_scalar_mul as jg2
from plonky2_bn254_tpu.starks.table import g2_scalar_mul_stark as jstark
from plonky2_bn254_tpu_torch.bn254 import oracle
from plonky2_bn254_tpu_torch.bn254.params import P as BN_P
from plonky2_bn254_tpu_torch.interop import u64_from_tensor
from plonky2_bn254_tpu_torch.starks import (air, bigint, fq2_alg, g1_scalar_mul, g2_add,
                                            g2_scalar_mul)
from plonky2_bn254_tpu_torch.starks.limbs import N_LIMBS, from_ints, h_int_to_limbs, h_limbs_to_int
from plonky2_bn254_tpu_torch.starks.table import g2_scalar_mul_stark
from torch_constraint_case import jax_case, port_accs

torch.set_num_threads(2)


def f2_dev(vals):
    """List of Fq2 tuples -> [2, k, 16] limb tensor (c0, c1 stacked)."""
    return torch.stack([from_ints([v[0] for v in vals]), from_ints([v[1] for v in vals])])


def f2_host(t, i):
    return (h_limbs_to_int(t[0, i].tolist()), h_limbs_to_int(t[1, i].tolist()))


def _f2_values(rng, k):
    vals = [(oracle.random_fq(rng), oracle.random_fq(rng)) for _ in range(k)]
    vals[:4] = [(0, 0), (1, 0), (0, BN_P - 1), (BN_P - 1, BN_P - 1)]
    return vals


F2_OPS = {
    "mul": (lambda a, b: fq2_alg.f2_mul(a, b), lambda a, b: jfq2.f2_mul(a, b),
            oracle.fq2_mul),
    "inv": (lambda a, b: fq2_alg.f2_inv(a), lambda a, b: jfq2.f2_inv(a),
            lambda a, b: oracle.fq2_inv(a)),
    "small": (lambda a, b: fq2_alg.f2_small(8, a), lambda a, b: jfq2.f2_small(8, a),
              lambda a, b: oracle.fq2_mul_scalar(a, 8)),
    "add": (fq2_alg.f2_add, jfq2.f2_add, oracle.fq2_add),
    "sub": (fq2_alg.f2_sub, jfq2.f2_sub, oracle.fq2_sub),
}


@pytest.mark.parametrize("op", list(F2_OPS))
def test_fq2_arithmetic_matches_jax_and_oracle(op):
    port, jax_fn, host = F2_OPS[op]
    rng = np.random.default_rng(51)
    a, b = _f2_values(rng, 12), _f2_values(rng, 12)[::-1]
    da, db = f2_dev(a), f2_dev(b)
    got = port(da, db)
    want = jax_fn((jnp.asarray(da[0].numpy()), jnp.asarray(da[1].numpy())),
                  (jnp.asarray(db[0].numpy()), jnp.asarray(db[1].numpy())))
    np.testing.assert_array_equal(got.numpy(), np.stack([np.asarray(w) for w in want]))
    for i in range(len(a)):
        assert f2_host(got, i) == host(a[i], b[i]), i


@pytest.fixture(scope="module")
def g2_points():
    rng = np.random.default_rng(7)
    return [oracle.random_g2(rng) for _ in range(6)]


CURVES = {"g1": (g1_scalar_mul.CURVE, oracle.random_g1, oracle.g1_add),
          "g2": (g2_scalar_mul.CURVE, oracle.random_g2, oracle.g2_add)}


@pytest.mark.parametrize("step", ["double", "mixed_add"])
@pytest.mark.parametrize("curve", list(CURVES))
def test_jacobian_step_matches_oracle(curve, step):
    """One double of an affine point, or one mixed_add of a Jacobian point
    (Z != 1, from a doubling) and an affine one, normalised with to_affine,
    against the oracle: the steps of `scalar_mul`'s chains over each curve."""
    c, random_point, add = CURVES[curve]
    rng = np.random.default_rng(7)
    pts = [random_point(rng) for _ in range(6)]
    pts, qs = pts[:3], pts[3:]

    def coords(points):
        """Affine points -> (x, y) tensors, as the machine's input bundle gives them."""
        cols = torch.tensor([[limb for v in c.ints(p) for limb in h_int_to_limbs(v)]
                             for p in points])
        w = c.degree * N_LIMBS
        return c.coord(cols[:, :w]), c.coord(cols[:, w:])

    X, Y = coords(pts)
    Z = torch.zeros_like(X)
    Z[(0,) * c.axis + (..., 0)] = 1
    X, Y, Z = c.double(X, Y, Z)
    want = [add(p, p) for p in pts]
    if step == "mixed_add":
        X, Y, Z = c.mixed_add(X, Y, Z, *coords(qs))
        want = [add(w, q) for w, q in zip(want, qs)]
    blocks = c.blocks(*c.to_affine(X, Y, Z))
    for i, w in enumerate(want):
        assert [h_limbs_to_int(b[i].tolist()) for b in blocks] == c.ints(w), i


def _gl_values(block):
    """[k, m] int64 columns -> list of m GL ring values over k rows."""
    return [air.GL(block[:, j].contiguous()) for j in range(block.shape[1])]


@pytest.mark.parametrize("pair", ["distinct", "doubling"])
def test_g2_add_witness_matches_oracle_and_satisfies_constraints(g2_points, pair):
    pairs = ([(g2_points[0], g2_points[1]), (g2_points[2], g2_points[4])] if pair == "distinct"
             else [(g2_points[2], g2_points[2]), (g2_points[5], g2_points[5])])
    ax, ay = f2_dev([a[0] for a, _ in pairs]), f2_dev([a[1] for a, _ in pairs])
    bx, by = f2_dev([b[0] for _, b in pairs]), f2_dev([b[1] for _, b in pairs])
    cx, cy, aux = g2_add.generate_g2_add(ax, ay, bx, by)
    for i, (a, b) in enumerate(pairs):
        assert (f2_host(cx, i), f2_host(cy, i)) == oracle.g2_add(a, b), i
        assert int(aux.is_x_eq[i]) == int(a[0] == b[0])

    # the port's constraints vanish on the witness (generic GL-ring path)
    ring = air.GLRing((len(pairs),), "cpu")
    consumer = air.ConstraintConsumer(ring, [ring.const(9)], ring.one(), ring.one(), ring.one())
    modulus = [ring.const(m) for m in bigint.MOD_LIMBS_INT]

    def pt(x, y):
        return {"x": _gl_values(torch.cat([x[0], x[1]], -1)),
                "y": _gl_values(torch.cat([y[0], y[1]], -1))}

    aux_cols = torch.cat(g2_scalar_mul._aux_cols(aux), -1)
    assert aux_cols.shape[-1] == g2_add.G2_ADD_AUX_LEN
    g2_add.eval_g2_add(consumer, ring, ring.one(), modulus, pt(ax, ay), pt(bx, by), pt(cx, cy),
                       g2_add.G2_ADD_AUX_LAYOUT.view(_gl_values(aux_cols)))
    assert consumer.count > 0
    assert (consumer.accs[0].v == 0).all()


@pytest.fixture(scope="module")
def one_op():
    rng = np.random.default_rng(51)
    s = int(rng.integers(1, 1 << 63)) << 150 | int(rng.integers(0, 1 << 63))
    x, offset = oracle.random_g2(rng), oracle.random_g2(rng)
    inputs = [(s, x, offset, 0)]
    return inputs, g2_scalar_mul.generate_trace(inputs, min_rows=512, device="cpu")


def test_trace_last_row_and_layout(one_op):
    inputs, trace = one_op
    assert trace.shape == (512, 1295) and trace.dtype == torch.int64
    s, x, offset, _ = inputs[0]
    L = g2_scalar_mul.LAYOUT
    rx, ry = L.range("sum", "x"), L.range("sum", "y")
    last = trace[511].tolist()
    got = ((h_limbs_to_int(last[rx.start : rx.start + 16]), h_limbs_to_int(last[rx.start + 16 : rx.stop])),
           (h_limbs_to_int(last[ry.start : ry.start + 16]), h_limbs_to_int(last[ry.start + 16 : ry.stop])))
    assert got == oracle.g2_add(oracle.g2_mul(x, s), offset)
    # layout pins (those of tests/test_g2.py)
    assert L.col("round_flags", "is_first_round") == 5 * 64 + 708 + 256
    assert L.col("timestamp") == 5 * 64 + 708 + 256 + 5
    assert g2_scalar_mul.FREQ_COL == 1295 - 2
    assert g2_scalar_mul.RANGE_COUNTER_COL == 1295 - 1


def test_layouts_match_jax():
    from plonky2_bn254_tpu.starks import g2_add as jg2_add

    for port, orig in [(g2_scalar_mul.LAYOUT, jg2.LAYOUT),
                       (g2_add.G2_ADD_AUX_LAYOUT, jg2_add.G2_ADD_AUX_LAYOUT)]:
        assert (port.width, port.offsets) == (orig.width, orig.offsets)
    assert g2_scalar_mul.RANGE_CHECK_COLS == jg2.RANGE_CHECK_COLS
    assert [vars(x) for x in g2_scalar_mul.lookups()] == [vars(x) for x in jg2.lookups()]
    assert [vars(x) for x in g2_scalar_mul.ctls()] == [vars(x) for x in jg2.ctls()]


def test_trace_defaults_to_the_card():
    """Without `device`, generate_trace builds on CUDA: with no card it
    raises, as torch does, rather than building on the CPU."""
    rng = np.random.default_rng(2)
    inputs = [(5, oracle.random_g2(rng), oracle.random_g2(rng), 0)]
    if torch.cuda.is_available():
        assert g2_scalar_mul.generate_trace(inputs).device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError)):
        g2_scalar_mul.generate_trace(inputs)


def test_ctl_values_match_jax():
    rng = np.random.default_rng(9)
    inputs = [(int(rng.integers(1, 1 << 63)) << 100 | t, oracle.random_g2(rng),
               oracle.random_g2(rng), t) for t in range(2)]
    assert g2_scalar_mul.generate_ctl_values(inputs) == jg2.generate_ctl_values(inputs)


@pytest.fixture(scope="module")
def constraint_case():
    return jax_case(jstark(), g2_scalar_mul_stark(), seed=6)


@pytest.mark.parametrize("stacked", [True, False])
def test_constraint_evaluation_matches_jax(constraint_case, stacked):
    """Every G2 constraint (AIR, LogUp, CTL) alpha-combined over random row
    values: the port's GL ring, stacked and generic, against JAX's."""
    count, accs = port_accs(constraint_case, g2_scalar_mul_stark(), stacked)
    assert count == constraint_case["count"]
    np.testing.assert_array_equal(accs, constraint_case["want"])


@pytest.mark.slow
def test_trace_bit_identical_to_jax(one_op):
    inputs, trace = one_op
    want = np.asarray(jg2.generate_trace(inputs, min_rows=512))
    np.testing.assert_array_equal(u64_from_tensor(trace), want)


@pytest.mark.slow
def test_g2_proof_equals_jax_field_by_field(one_op):
    """G2 at 1 op and 512 rows under TEST_CONFIG.  Fewer than 2^16 rows
    cannot satisfy the range-counter constraint, so neither proof verifies;
    the two provers must agree bit for bit."""
    from plonky2_bn254_tpu.prover import prove as jprove
    from plonky2_bn254_tpu.prover.config import TEST_CONFIG as JTEST_CONFIG
    from plonky2_bn254_tpu_torch.interop import proof_to_fields
    from plonky2_bn254_tpu_torch.prover import prove as prove_mod
    from plonky2_bn254_tpu_torch.prover.config import TEST_CONFIG
    from test_torch_prove import assert_fields_equal

    inputs, trace = one_op
    ctl = g2_scalar_mul.generate_ctl_values(inputs)
    tproof = prove_mod.prove(g2_scalar_mul_stark(), trace, ctl, TEST_CONFIG)
    jproof = jprove.prove(jstark(), jnp.asarray(u64_from_tensor(trace)), ctl, JTEST_CONFIG)
    assert_fields_equal(proof_to_fields(tproof), proof_to_fields(jproof))
