"""The plain reference on the CPU: its field, Poseidon and BN254 against the
values the repository's tests pin and against the program's own host code,
and its verifier on proofs of the demo-sized pieces it shares."""

import numpy as np
import pytest

from reference import bn254, machines
from reference import field as F
from reference import verify
from reference.stark import Consumer

# tests/test_golden.py pins these for the program's Poseidon and challenger
GOLDEN_PERMUTE_0_11 = [
    14138987725437233860, 12268065125637552196, 4360177879303081409, 4913642308894958418,
    17693386466870949085, 4451297792300200175, 10276795135555006987, 13542845953015401521,
    13504109063569109964, 9081958872113790443, 15891657147414207249, 10326867235590626527,
]
GOLDEN_HASH_0_7 = [12066618972578209461, 4637708317505398720, 16916745019799912021,
                   364530545390893550]
GOLDEN_TWO_TO_ONE = [13511116127243146388, 14988061387746007837, 7486144431923622197,
                     8070264918417733669]
GOLDEN_CHALLENGE = 14043805357755449006
GOLDEN_EXT = (12469280705078976453, 932590098754499815)

# alt_bn128: 2 * (1, 2)
G1_DOUBLE = (0x030644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD3,
             0x15ED738C0E0A7C92E7845F96B2AE9C0A68A6A449E3538FC7FF3EBF7A5A18A2C4)
BN254_R = 21888242871839275222246405745257275088548364400416034343698204186575808495617


def test_poseidon_golden_vectors():
    assert F.permute(list(range(12))) == GOLDEN_PERMUTE_0_11
    assert [int(x) for x in F.np_hash_no_pad(np.arange(8, dtype=np.uint64)[None])[0]] \
        == GOLDEN_HASH_0_7
    two = F.np_two_to_one(np.array([[1, 2, 3, 4]], dtype=np.uint64),
                          np.array([[5, 6, 7, 8]], dtype=np.uint64))
    assert [int(x) for x in two[0]] == GOLDEN_TWO_TO_ONE


def test_challenger_golden():
    ch = verify.Challenger()
    ch.observe_all(range(5))
    assert ch.challenge() == GOLDEN_CHALLENGE
    ext = ch.ext_challenge()
    assert (ext.c0, ext.c1) == GOLDEN_EXT


def test_batched_permutation_equals_scalar():
    rng = np.random.default_rng(3)
    states = rng.integers(0, F.P, (17, 12), dtype=np.uint64)
    states[0] = F.P - 1
    got = F.np_permute(states)
    for row, out in zip(states, got):
        assert [int(x) for x in out] == F.permute([int(x) for x in row])


def test_numpy_field_ops():
    rng = np.random.default_rng(4)
    a = rng.integers(0, F.P, 2000, dtype=np.uint64)
    b = rng.integers(0, F.P, 2000, dtype=np.uint64)
    a[:3] = [0, F.P - 1, F.P - 1]
    b[:3] = [F.P - 1, F.P - 1, 1]
    mul, add = F.np_mul(a, b), F.np_add(a, b)
    for i in range(2000):
        assert int(mul[i]) == int(a[i]) * int(b[i]) % F.P
        assert int(add[i]) == (int(a[i]) + int(b[i])) % F.P


def test_merkle_batch_verify():
    rng = np.random.default_rng(5)
    leaves = rng.integers(0, F.P, (32, 11), dtype=np.uint64)
    level = F.np_hash_no_pad(leaves)
    levels = [level]
    while level.shape[0] > 4:  # cap of 4
        level = F.np_two_to_one(level[0::2], level[1::2])
        levels.append(level)
    idx = np.array([0, 5, 31, 12])
    paths = np.stack([np.stack([levels[d][(i >> d) ^ 1] for d in range(len(levels) - 1)])
                      for i in idx])
    digests = F.np_hash_no_pad(leaves[idx])
    assert F.np_merkle_verify(digests, idx, paths, levels[-1]).all()
    paths[2, 1, 0] ^= np.uint64(1)
    assert F.np_merkle_verify(digests, idx, paths, levels[-1]).tolist() == [True, True, False, True]


def test_bn254_pins():
    g = (1, 2)
    assert bn254.on_curve(g) and bn254.g1_mul(g, 2) == G1_DOUBLE
    assert bn254.g1_add(g, g) == G1_DOUBLE
    assert bn254.g1_mul(g, BN254_R) is None
    assert bn254.g1_mul(g, BN254_R + 5) == bn254.g1_mul(g, 5)
    assert bn254.sqrt(4) in (2, bn254.P - 2)


def test_bn254_agrees_with_the_program_oracle():
    from plonky2_bn254_tpu_torch.bn254 import oracle

    from yardstick import traffic

    for s, x, offset in traffic.operations(11, "window", 0, ["scalar", "g1", "g1"], 6,
                                           {"high_bits": 63, "high_shift": 192, "low_bits": 63}):
        assert bn254.g1_add(bn254.g1_mul(x, s), offset) == oracle.g1_add(oracle.g1_mul(x, s),
                                                                          offset)


@pytest.mark.parametrize("name,module", [("g1_scalar_mul", "g1_scalar_mul"),
                                         ("fq_exp", "fq_exp")])
def test_machine_layout_and_statement_match_the_program(name, module):
    """The frozen machine definitions against the program's, field by field
    (the reference imports nothing of the program; this test does)."""
    import importlib

    from plonky2_bn254_tpu_torch.starks import table

    prog = importlib.import_module(f"plonky2_bn254_tpu_torch.starks.{module}")
    stark = getattr(table, f"{module}_stark")()
    ref = machines.machine(name)
    assert ref.width == stark.width
    assert [(lk.columns, lk.table_col, lk.freq_col) for lk in ref.lookups] == \
        [(lk.columns, lk.table_col, lk.freq_col) for lk in stark.lookups]
    assert [(c.columns, c.filter_col) for c in ref.ctls] == \
        [(c.columns, c.filter_col) for c in stark.ctls]
    from yardstick import traffic

    operands = ["scalar", "g1", "g1"] if name == "g1_scalar_mul" else ["scalar", "fq"]
    ops = traffic.operations(12, "window", 0, operands, 3,
                             {"high_bits": 63, "high_shift": 192, "low_bits": 63})
    assert ref.ctl_values(ops) == prog.generate_ctl_values([op + (t,) for t, op in
                                                           enumerate(ops)])


@pytest.mark.parametrize("name,module", [("g1_scalar_mul", "g1_scalar_mul"),
                                         ("fq_exp", "fq_exp")])
def test_constraints_match_the_program_at_a_random_point(name, module):
    """The same constraint values, in the same order, as the program's
    evaluation through its extension-scalar ring."""
    import importlib

    from plonky2_bn254_tpu_torch.field.extension import GLExt
    from plonky2_bn254_tpu_torch.starks.air import ConstraintConsumer, HostExtRing

    prog = importlib.import_module(f"plonky2_bn254_tpu_torch.starks.{module}")
    ref = machines.machine(name)
    rng = np.random.default_rng(6)
    vals = [[(int(a), int(b)) for a, b in rng.integers(0, F.P, (ref.width, 2), dtype=np.uint64)]
            for _ in range(2)]
    alphas, zl, lf, ll = [(int(a), int(b)) for a, b in rng.integers(0, F.P, (5, 2),
                                                                       dtype=np.uint64)][:2], \
        (3, 4), (5, 6), (7, 8)
    mine = Consumer([F.Ext(*a) for a in alphas], F.Ext(*zl), F.Ext(*lf), F.Ext(*ll))
    ref.eval_fn(mine, F.ExtRing(), [F.Ext(*v) for v in vals[0]], [F.Ext(*v) for v in vals[1]])
    theirs = ConstraintConsumer(HostExtRing(), [GLExt(*a) for a in alphas], GLExt(*zl),
                                GLExt(*lf), GLExt(*ll))
    getattr(prog, f"eval_{module}")(theirs, HostExtRing(), [GLExt(*v) for v in vals[0]],
                                    [GLExt(*v) for v in vals[1]])
    assert [(a.c0, a.c1) for a in mine.accs] == [(a.c0, a.c1) for a in theirs.accs]


def _small_circuit(poseidon: bool):
    """The program's circuit API on the CPU: c = a*x + d with a 12-bit range
    check on d, optionally through two in-circuit permutations; publics a, c."""
    from plonky2_bn254_tpu_torch import circuit as ckt
    from plonky2_bn254_tpu_torch.circuit import poseidon_gadget as pg
    from plonky2_bn254_tpu_torch.circuit.biguint import range_check

    b = ckt.CircuitBuilder()
    a, x, d = (b.add_virtual_target() for _ in range(3))
    out = b.mul_add(a, x, d)
    if poseidon:
        out = pg.permute_targets(b, pg.permute_targets(b, [out] + [a] * 11))[0]
    range_check(b, d, 12)
    b.register_public_input(a)
    b.register_public_input(out)
    pw = ckt.Witness()
    for t, v in zip((a, x, d), (1234, 5678, 4095)):
        pw.set_target(t, v)
    return b.build(), pw


@pytest.mark.parametrize("poseidon", [False, True])
def test_outer_reference_accepts_the_program_proof_and_rejects_tampering(poseidon):
    import dataclasses

    from plonky2_bn254_tpu_torch.circuit import outer as prog_outer
    from plonky2_bn254_tpu_torch.interop import u64_from_tensor
    from plonky2_bn254_tpu_torch.prover.config import TEST_CONFIG

    from reference import outer
    from yardstick.proofs import plain_proof

    circuit, pw = _small_circuit(poseidon)
    data = circuit.outer_data(8, "cpu")
    proof, publics = prog_outer.prove_outer(data, circuit.generate_witness(pw, "cpu"),
                                            TEST_CONFIG)
    plain, cfg = plain_proof(proof), dataclasses.asdict(TEST_CONFIG)
    lay = outer.OuterLayout(data.lay.S, data.lay.Q, data.lay.R, data.lay.NP)
    assert lay.width == data.lay.width and lay.idx == data.lay.idx
    machine = outer.outer_machine(lay, data.pub_wires)
    const = u64_from_tensor(data.const_cols)

    def judge(publics, const):
        check = outer.constant_column_check(lay, const, data.n_log, np.random.default_rng(1))
        return verify.verify(machine, plain, machine.ctl_values(publics), cfg, data.n_log, check)

    assert judge(publics, const) is None
    assert judge([publics[0], publics[1] + 1], const) is not None
    other = const.copy()
    other[lay.qcol - lay.idx, 0] ^= 1  # a gate coefficient of the first row
    assert judge(publics, other) == "the constant columns' openings differ from the circuit's"
