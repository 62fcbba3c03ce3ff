"""The port's outer prover against the JAX package's.

The circuits of tests/test_outer.py (small, bad witness, verifier-key
pinning, Poseidon region, Fq gadget) at table_bits 8/10 and TEST_CONFIG are
recorded by both packages.  Exact comparisons (tolerance 0): the port's
constant columns, verifier key and outer trace equal the JAX package's; the
port's outer proof equals JAX's field by field; each package's
`verify_outer` accepts the other's proof; and the port rejects every tamper
case those tests reject.  The JAX runs are made once per module.
"""

import dataclasses

import numpy as np
import pytest
import torch

from plonky2_bn254_tpu import circuit as jckt
from plonky2_bn254_tpu.bn254 import oracle as joracle
from plonky2_bn254_tpu.circuit import outer as jouter
from plonky2_bn254_tpu.circuit import poseidon_gadget as jpg
from plonky2_bn254_tpu.circuit.biguint import range_check as jrange_check
from plonky2_bn254_tpu.prover.config import TEST_CONFIG as JTEST_CONFIG
from plonky2_bn254_tpu_torch import circuit as ckt
from plonky2_bn254_tpu_torch.bn254 import oracle, params
from plonky2_bn254_tpu_torch.circuit import outer
from plonky2_bn254_tpu_torch.circuit import poseidon_gadget as pg
from plonky2_bn254_tpu_torch.circuit.biguint import range_check
from plonky2_bn254_tpu_torch.field import goldilocks as gl
from plonky2_bn254_tpu_torch.field import poseidon
from plonky2_bn254_tpu_torch.field.poseidon_constants import FULL_ROUNDS, N_ROUNDS
from plonky2_bn254_tpu_torch.interop import (
    outer_tables_from_numpy,
    outer_tables_to_numpy,
    proof_from_fields,
    proof_to_fields,
    u64_from_tensor,
)
from plonky2_bn254_tpu_torch.prover import prove as prove_mod
from plonky2_bn254_tpu_torch.prover.config import TEST_CONFIG
from plonky2_bn254_tpu_torch.prover.verify import VerificationError

from test_torch_prove import assert_fields_equal, to_jax_proof

torch.set_num_threads(2)

JAX = (jckt, joracle, jrange_check, jpg)
PORT = (ckt, oracle, range_check, pg)


def _small(c, o, rc, p, rng, inputs=(1234, 5678, 4095)):
    """c = a*b + d with a 12-bit range check on d; publics: a, c."""
    b = c.CircuitBuilder()
    a = b.add_virtual_target()
    x = b.add_virtual_target()
    d = b.add_virtual_target()
    out = b.mul_add(a, x, d)
    rc(b, d, 12)
    b.register_public_input(a)
    b.register_public_input(out)
    pw = c.Witness()
    for t, v in zip((a, x, d), inputs):
        pw.set_target(t, v)
    return b, pw, (a, x, d, out)


def _vk2(c, o, rc, p, rng):
    """Same geometry as `_small`, different constants: c = a*b + 2d."""
    b = c.CircuitBuilder()
    a = b.add_virtual_target()
    x = b.add_virtual_target()
    d = b.add_virtual_target()
    out = b.add(b.mul_add(a, x, d), d)
    rc(b, d, 12)
    b.register_public_input(a)
    b.register_public_input(out)
    pw = c.Witness()
    for t, v in zip((a, x, d), (3, 4, 7)):
        pw.set_target(t, v)
    return b, pw, (a, x, d, out)


def _poseidon(c, o, rc, p, rng):
    """Two chained in-circuit permutations plus a gate on their output."""
    b = c.CircuitBuilder()
    ins = [b.add_virtual_target() for _ in range(12)]
    outs = p.permute_targets(b, p.permute_targets(b, ins))
    prod = b.mul_add(outs[0], outs[1], outs[2])
    b.register_public_input(outs[0])
    b.register_public_input(prod)
    pw = c.Witness()
    for t, v in zip(ins, rng.integers(0, gl.P, size=12, dtype=np.uint64)):
        pw.set_target(t, int(v))
    return b, pw, (ins, outs)


def _fq_gadget(c, o, rc, p, rng):
    """Fq mul with lazy reduction and a hint inverse; publics: the product."""
    b = c.CircuitBuilder()
    x = c.FqTarget.new_unchecked(b)
    y = c.FqTarget.new_unchecked(b)
    m = x.mul(b, y).take_mod(b)
    inv = x.inv(b)
    for t in m.value.limbs:
        b.register_public_input(t)
    pw = c.Witness()
    xv, yv = o.random_fq(rng), o.random_fq(rng)
    x.set_witness(pw, xv)
    y.set_witness(pw, yv)
    return b, pw, (m, inv, xv, yv)


CIRCUITS = {"small": (_small, 8), "vk2": (_vk2, 8), "poseidon": (_poseidon, 8),
            "fq": (_fq_gadget, 10)}


class Built:
    def __init__(self, name, pkg):
        build, self.table_bits = CIRCUITS[name]
        b, pw, self.targets = build(*pkg, np.random.default_rng(2024))
        self.circuit = b.build()
        if pkg is PORT:
            self.values = self.circuit.generate_witness(pw, device="cpu")
            self.data = outer.compile_outer(self.circuit, self.table_bits, device="cpu")
        else:
            self.values = self.circuit.generate_witness(pw)
            self.data = jouter.compile_outer(self.circuit, self.table_bits)


@pytest.fixture(scope="module")
def built():
    return {name: (Built(name, JAX), Built(name, PORT)) for name in CIRCUITS}


@pytest.fixture(scope="module")
def proofs(built):
    """name -> (JAX proof, port proof, publics): one prove per package."""
    out = {}
    for name, (j, p) in built.items():
        jproof, jpub = jouter.prove_outer(j.data, j.values, JTEST_CONFIG)
        proof, pub = outer.prove_outer(p.data, p.values, TEST_CONFIG)
        assert pub == jpub
        out[name] = (jproof, proof, pub)
    return out


def _bad_witnesses(name, p):
    """The dishonest witnesses of tests/test_outer.py for circuit `name`."""
    if name == "small":
        a, x, d, out = p.targets
        bad = dict(p.values)
        bad[out.index] = (bad[out.index] + 1) % gl.P  # c != a*x + d
        bad2 = dict(p.values)
        bad2[d.index] = 1 << 13  # d out of its 12-bit range
        bad2[out.index] = (bad2[a.index] * bad2[x.index] + bad2[d.index]) % gl.P
        return {"bad_product": bad, "bad_range": bad2}
    if name == "fq":
        limb = p.targets[0].value.limbs[0].index
        bad = dict(p.values)
        bad[limb] = (bad[limb] + 1) % gl.P
        return {"bad_limb": bad}
    return {}


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_outer_tables_and_trace_equal_jax(built, name):
    j, p = built[name]
    assert p.values == j.values
    assert (p.data.n_log, p.data.n_wires, p.data.n_gate_rows, p.data.pub_wires) == (
        j.data.n_log, j.data.n_wires, j.data.n_gate_rows, j.data.pub_wires)
    assert dataclasses.astuple(p.data.lay) == dataclasses.astuple(j.data.lay)
    assert (p.data.lay.width, p.data.lay.const_cols) == (j.data.lay.width, j.data.lay.const_cols)
    assert p.data.n_pos == j.data.n_pos
    const_np, vk_np = outer_tables_to_numpy(p.data.const_cols, p.data.vk_coeffs)
    np.testing.assert_array_equal(const_np, j.data.const_cols_np)
    np.testing.assert_array_equal(vk_np, np.asarray(j.data.vk_coeffs))
    back = outer_tables_from_numpy(j.data.const_cols_np, np.asarray(j.data.vk_coeffs))
    assert torch.equal(back[0], p.data.const_cols) and torch.equal(back[1], p.data.vk_coeffs)
    witnesses = {"honest": (p.values, j.values)}
    for case, bad in _bad_witnesses(name, p).items():
        witnesses[case] = (bad, bad)
    for case, (pv, jv) in witnesses.items():
        trace, pub, ctl = outer.build_outer_trace(p.data, pv)
        jtrace, jpub, jctl = jouter.build_outer_trace(j.data, jv)
        np.testing.assert_array_equal(u64_from_tensor(trace), np.asarray(jtrace), err_msg=case)
        assert (pub, ctl) == (jpub, jctl), case


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_outer_proof_equals_jax_and_cross_verifies(built, proofs, name):
    j, p = built[name]
    jproof, proof, pub = proofs[name]
    fields = proof_to_fields(proof)
    assert_fields_equal(fields, proof_to_fields(jproof))
    jouter.verify_outer(j.data, to_jax_proof(fields), pub, JTEST_CONFIG)
    outer.verify_outer(p.data, proof, pub, TEST_CONFIG)
    outer.verify_outer(p.data, proof_from_fields(proof_to_fields(jproof)), pub, TEST_CONFIG)


def _flip_opening(proof):
    fields = proof_to_fields(proof)
    c0, c1 = fields["openings"]["trace_zeta"][0]
    fields["openings"]["trace_zeta"][0] = ((c0 + 1) % gl.P, c1)
    return proof_from_fields(fields)


def _forged_region(data, trace):
    """A Poseidon region whose second block is honestly recomputed from a
    forged input state: internally consistent, but proving a permutation the
    circuit never recorded."""
    lay = data.lay
    t = trace.clone()
    rc, mds = poseidon._tables(t.device)
    half = FULL_ROUNDS // 2
    row0 = data.pos_base + outer.POS_BLOCK
    state = t[row0, lay.ps : lay.ps + 12].clone()
    state[0] = gl.add(state[0:1], 1)[0]
    for r in range(N_ROUNDS + 1):
        u = gl.add(state, rc[r]) if r < N_ROUNDS else state
        x3 = gl.mul(gl.mul(u, u), u)
        x7 = gl.mul(gl.mul(x3, x3), u)
        t[row0 + r, lay.ps : lay.ps + 12] = state
        t[row0 + r, lay.px3 : lay.px3 + 12] = x3
        t[row0 + r, lay.px7 : lay.px7 + 12] = x7
        if r == N_ROUNDS:
            break
        full = r < half or r >= N_ROUNDS - half
        sel = x7 if full else torch.cat([x7[:1], u[1:]])
        state = poseidon._mds_layer(sel, mds)
    return t


TAMPER = ["wrong_public", "flipped_opening", "bad_product", "bad_range", "other_vk",
          "forged_round_state", "forged_region", "bad_limb"]


@pytest.mark.parametrize("case", TAMPER)
def test_outer_rejects_tampering(built, proofs, case):
    name = {"other_vk": "vk2", "forged_round_state": "poseidon", "forged_region": "poseidon",
            "bad_limb": "fq"}.get(case, "small")
    _, p = built[name]
    _, proof, pub = proofs[name]
    data = p.data
    if case == "wrong_public":
        pub = [pub[0], 999]
    elif case == "flipped_opening":
        proof = _flip_opening(proof)
    elif case in ("bad_product", "bad_range", "bad_limb"):
        proof, pub = outer.prove_outer(data, _bad_witnesses(name, p)[case], TEST_CONFIG)
    elif case == "other_vk":
        # a valid proof of the second circuit, against the first one's key
        data = built["small"][1].data
        assert (data.n_log, data.lay) == (p.data.n_log, p.data.lay)
    else:
        trace, pub, ctl = outer.build_outer_trace(data, p.values)
        if case == "forged_round_state":
            bad = trace.clone()
            cell = (data.pos_base + 5, data.lay.ps + 3)
            bad[cell] = gl.add(bad[cell].reshape(1), 1)[0]
        else:
            bad = _forged_region(data, trace)
        proof = prove_mod.prove(data.stark, bad, ctl, TEST_CONFIG)
    with pytest.raises(VerificationError):
        outer.verify_outer(data, proof, pub, TEST_CONFIG)


def test_outer_rejects_value_far_outside_a_narrow_range():
    """A wire far above a range check narrower than the table (its limb
    cell `v << (B - bits)` wraps past 2^63) still gives a trace and a proof,
    which the verifier rejects.  The JAX package's build_outer_trace raises
    on this witness (np.bincount of a negative cell) instead."""
    b = ckt.CircuitBuilder()
    d = b.add_virtual_target()
    b.register_public_input(b.add(d, d))
    range_check(b, d, 6)
    circuit = b.build()
    data = outer.compile_outer(circuit, 8, device="cpu")
    for value, honest in ((63, True), (gl.P - 1, False)):
        pw = ckt.Witness()
        pw.set_target(d, value)
        proof, pub = outer.prove_outer(data, circuit.generate_witness(pw, device="cpu"),
                                       TEST_CONFIG)
        if honest:
            outer.verify_outer(data, proof, pub, TEST_CONFIG)
        else:
            with pytest.raises(VerificationError):
                outer.verify_outer(data, proof, pub, TEST_CONFIG)


def test_outer_proof_with_the_device_transcript_equals_the_host_one(built, proofs):
    """`prove_outer` takes `prove`'s default, the device transcript on the
    card; on the CPU both transcripts give the same outer proof field by
    field, and it verifies."""
    _, p = built["small"]
    trace, pub, ctl = outer.build_outer_trace(p.data, p.values)
    dev = prove_mod.prove(p.data.stark, trace, ctl, TEST_CONFIG, device_fs=True)
    host = prove_mod.prove(p.data.stark, trace, ctl, TEST_CONFIG, device_fs=False)
    fields = proof_to_fields(dev)
    assert_fields_equal(fields, proof_to_fields(host))
    assert_fields_equal(fields, proof_to_fields(proofs["small"][1]))
    outer.verify_outer(p.data, dev, pub, TEST_CONFIG)


def test_outer_outputs_are_the_circuit_values(built, proofs):
    """The publics are the witness values the gadgets compute."""
    _, p = built["fq"]
    m, inv, xv, yv = p.targets
    assert m.get_witness(p.values) == xv * yv % params.P
    assert inv.get_witness(p.values) == pow(xv, -1, params.P)
    _, _, pub = proofs["fq"]
    assert sum(v << (32 * i) for i, v in enumerate(pub)) == xv * yv % params.P
    _, ps = built["poseidon"]
    ins, outs = ps.targets
    want = poseidon.h_permute(poseidon.h_permute([ps.values[t.index] for t in ins]))
    assert [ps.values[t.index] for t in outs] == want


def test_entry_points_need_the_card_by_default(built):
    """Without a card, the compose entry points refuse the default device
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the card tests cover this path")
    _, p = built["small"]
    with pytest.raises((RuntimeError, AssertionError)):
        outer.compile_outer(p.circuit, p.table_bits)
    with pytest.raises((RuntimeError, AssertionError)):
        p.circuit.check(p.values)
