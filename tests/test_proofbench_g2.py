"""The benchmark's plain G2 reference on the CPU (proofbench/reference/
bn254_g2.py, machines/g2_scalar_mul.py, yardstick/operands/g2.py) against
the port's oracle, layout, statement and constraints, and the judge of a
G2 cell counting a wrong statement.

A G2 proof needs 2^16 rows (its range table counts 0 .. 2^16 - 1), so the
one test that proves and judges a whole G2 proof on the CPU is slow."""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
for path in (str(ROOT), str(ROOT / "proofbench")):
    if path not in sys.path:
        sys.path.insert(0, path)

from reference import bn254_g2, machines  # noqa: E402
from reference import field as F  # noqa: E402
from reference.stark import Consumer  # noqa: E402
from yardstick import traffic  # noqa: E402
from yardstick.operands import g2 as g2_operand  # noqa: E402

SCALAR = {"high_bits": 63, "high_shift": 192, "low_bits": 63}
OPERANDS = ["scalar", "g2", "g2"]


def _ops(seed, count):
    return traffic.operations(seed, "window", 0, OPERANDS, count, SCALAR)


def test_bn254_g2_pins():
    from plonky2_bn254_tpu_torch.bn254 import oracle, params

    G = bn254_g2.GENERATOR
    assert G == params.G2_GENERATOR and bn254_g2.R == params.R
    assert bn254_g2.B_G2 == (params.B_G2_C0, params.B_G2_C1)
    assert bn254_g2.on_twist(G)
    assert bn254_g2.g2_mul(G, bn254_g2.R) is None
    assert bn254_g2.g2_mul(G, 2) == oracle.g2_mul(G, 2) == bn254_g2.g2_add(G, G)
    assert bn254_g2.g2_mul(G, bn254_g2.R + 5) == bn254_g2.g2_mul(G, 5)
    assert bn254_g2.g2_mul_add(G, bn254_g2.R - 1, G) is None


def test_statement_agrees_with_the_program_oracle():
    from plonky2_bn254_tpu_torch.bn254 import oracle

    for s, x, offset in _ops(11, 6):
        assert bn254_g2.g2_mul_add(x, s, offset) == oracle.g2_add(oracle.g2_mul(x, s), offset)


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 3_000_000_019])
def test_drawn_points_are_in_the_subgroup_and_pure_in_the_seed(seed):
    ops = _ops(seed, 2)
    assert ops == _ops(seed, 2)
    assert _ops(seed + 1, 2) != ops
    for _, x, offset in ops:
        for pt in (x, offset):
            assert bn254_g2.on_twist(pt)
            assert bn254_g2.g2_mul(pt, bn254_g2.R) is None


def test_drawn_point_is_k_times_the_generator():
    g = np.random.default_rng(5)
    state = g.bit_generator.state
    pt = g2_operand.draw(g)
    g.bit_generator.state = state
    k = int.from_bytes(g.bytes(40), "little") % (bn254_g2.R - 1) + 1
    assert pt == bn254_g2.g2_mul(bn254_g2.GENERATOR, k)


def test_machine_layout_and_statement_match_the_program():
    from plonky2_bn254_tpu_torch.starks import g2_scalar_mul, table

    stark = table.g2_scalar_mul_stark()
    ref = machines.machine("g2_scalar_mul")
    assert ref.width == stark.width == 1295
    assert [(lk.columns, lk.table_col, lk.freq_col) for lk in ref.lookups] == \
        [(lk.columns, lk.table_col, lk.freq_col) for lk in stark.lookups]
    assert [(c.columns, c.filter_col) for c in ref.ctls] == \
        [(c.columns, c.filter_col) for c in stark.ctls]
    ops = _ops(12, 3)
    assert ref.ctl_values(ops) == g2_scalar_mul.generate_ctl_values(
        [op + (t,) for t, op in enumerate(ops)])


@pytest.mark.parametrize("seed", [6, 7])
def test_constraints_match_the_program_at_a_random_point(seed):
    """The same constraint values, in the same order, as the program's
    evaluation through its extension-scalar ring."""
    from plonky2_bn254_tpu_torch.field.extension import GLExt
    from plonky2_bn254_tpu_torch.starks import g2_scalar_mul
    from plonky2_bn254_tpu_torch.starks.air import ConstraintConsumer, HostExtRing

    ref = machines.machine("g2_scalar_mul")
    rng = np.random.default_rng(seed)
    vals = [[(int(a), int(b)) for a, b in rng.integers(0, F.P, (ref.width, 2), dtype=np.uint64)]
            for _ in range(2)]
    alphas = [(int(a), int(b)) for a, b in rng.integers(0, F.P, (2, 2), dtype=np.uint64)]
    zl, lf, ll = (3, 4), (5, 6), (7, 8)
    mine = Consumer([F.Ext(*a) for a in alphas], F.Ext(*zl), F.Ext(*lf), F.Ext(*ll))
    ref.eval_fn(mine, F.ExtRing(), [F.Ext(*v) for v in vals[0]], [F.Ext(*v) for v in vals[1]])
    theirs = ConstraintConsumer(HostExtRing(), [GLExt(*a) for a in alphas], GLExt(*zl),
                                GLExt(*lf), GLExt(*ll))
    g2_scalar_mul.eval_g2_scalar_mul(theirs, HostExtRing(), [GLExt(*v) for v in vals[0]],
                                     [GLExt(*v) for v in vals[1]])
    assert [(a.c0, a.c1) for a in mine.accs] == [(a.c0, a.c1) for a in theirs.accs]


def test_judge_counts_one_altered_limb_of_the_program_statement():
    """The program's own statement, one limb of one output altered, counts
    as one wrong output against the reference's G2 arithmetic (the proof, a
    stub, is rejected besides)."""
    import run

    from plonky2_bn254_tpu_torch.starks import g2_scalar_mul

    drv_mod = run.load_module(run.HERE / "drivers" / "batch.py", "test_g2_batch_driver")
    config = run.load_json(run.HERE / "configs" / "g2_scalar_mul.json")
    mix = dict(run.load_json(run.HERE / "traffic" / "batch128.json"), ops_per_proof=3)
    drv = drv_mod.Driver(config, mix, 5, "cpu", False, lambda msg: None)
    _, inputs = drv._inputs("window", 0)
    stated = g2_scalar_mul.generate_ctl_values(inputs)
    drv.outputs = [(stated, {"degree_bits": 16})]
    assert drv.judge()["outputs_wrong"] == (0, 0)
    stated[1][1][17] ^= 1
    assert drv.judge() == {"proofs_rejected": (1, 0), "outputs_wrong": (1, 0)}


@pytest.mark.slow
def test_program_g2_proof_accepted_and_an_altered_output_rejected():
    """One program G2 proof of 2 operations at 2^16 rows, on the CPU: the
    reference verifier accepts it against the reference's statement and
    rejects it with one output limb altered."""
    from plonky2_bn254_tpu_torch.prover import prove
    from plonky2_bn254_tpu_torch.prover.config import TEST_CONFIG
    from plonky2_bn254_tpu_torch.starks import g2_scalar_mul, table

    from reference import verify
    from yardstick.proofs import plain_proof

    ops = _ops(13, 2)
    inputs = [op + (t,) for t, op in enumerate(ops)]
    trace = g2_scalar_mul.generate_trace(inputs, device="cpu")
    assert trace.shape == (1 << 16, 1295)
    proof = prove.prove(table.g2_scalar_mul_stark(), trace,
                        g2_scalar_mul.generate_ctl_values(inputs), TEST_CONFIG)
    plain, cfg = plain_proof(proof), dataclasses.asdict(TEST_CONFIG)
    ref = machines.machine("g2_scalar_mul")
    want = ref.ctl_values(ops)
    assert verify.verify(ref, plain, want, cfg, 16) is None
    want[1][1][3] ^= 1
    assert verify.verify(ref, plain, want, cfg, 16) is not None
