"""The port's in-circuit recursive STARK verifier.

Over the demo STARK at the small RECURSION_CONFIG of tests/test_recursion.py:
the verifier circuit the port records equals the JAX package's (targets,
templates, rows, constraints, Poseidon ops, generators); the witness set from
the port's own proof passes the port's `check`; a tampered proof or a CTL
value that disagrees with the trace fails it.  The gadget-vs-native cases
(permutation, sponge, challenger, extension ops, bit split) hold the port's
gadgets against the port's native code.
"""

import numpy as np
import pytest

from plonky2_bn254_tpu.circuit import builder as jbuilder
from plonky2_bn254_tpu.circuit import stark_verifier as jsv
from plonky2_bn254_tpu.prover.config import StarkConfig as JStarkConfig
from plonky2_bn254_tpu.starks import demo as jdemo
from plonky2_bn254_tpu_torch.circuit.builder import CircuitBuilder, Witness
from plonky2_bn254_tpu_torch.circuit.ext_target import (
    ExtOps,
    ExtTarget,
    random_access,
    split_le,
)
from plonky2_bn254_tpu_torch.circuit.poseidon_gadget import (
    RecursiveChallenger,
    hash_no_pad_targets,
    permute_targets,
)
from plonky2_bn254_tpu_torch.circuit.stark_verifier import (
    add_virtual_stark_proof,
    set_stark_proof_target,
    verify_stark_proof_circuit,
)
from plonky2_bn254_tpu_torch.field import goldilocks as gl
from plonky2_bn254_tpu_torch.field import poseidon
from plonky2_bn254_tpu_torch.field.extension import GLExt
from plonky2_bn254_tpu_torch.prover import prove as prove_mod
from plonky2_bn254_tpu_torch.prover import verify as verify_mod
from plonky2_bn254_tpu_torch.prover.challenger import Challenger
from plonky2_bn254_tpu_torch.prover.config import StarkConfig
from plonky2_bn254_tpu_torch.starks import demo

from test_torch_circuit import recorded

RNG = np.random.default_rng(33)

CONFIG_FIELDS = dict(
    num_challenges=2,
    rate_bits=1,
    cap_height=1,
    proof_of_work_bits=8,
    num_query_rounds=4,
    arity_bits=2,
    final_poly_degree_bits=3,
)
RECURSION_CONFIG = StarkConfig(**CONFIG_FIELDS)


def run_circuit(builder, pw):
    circuit = builder.build()
    values = circuit.generate_witness(pw, device="cpu")
    circuit.check(values, device="cpu")
    return values


def _rand():
    return int(RNG.integers(0, gl.P, dtype=np.uint64))


def test_permute_and_hash_match_native():
    b = CircuitBuilder()
    state_v = [_rand() for _ in range(12)]
    state_t = b.add_virtual_targets(12)
    out_t = permute_targets(b, state_t)
    msg_v = [_rand() for _ in range(11)]
    msg_t = b.add_virtual_targets(11)
    dig_t = hash_no_pad_targets(b, msg_t)
    pw = Witness()
    for t, v in zip(state_t + msg_t, state_v + msg_v):
        pw.set_target(t, v)
    values = run_circuit(b, pw)
    assert [values[t.index] for t in out_t] == poseidon.h_permute(state_v)
    assert [values[t.index] for t in dig_t] == poseidon.h_hash_no_pad(msg_v)


def test_recursive_challenger_matches_native():
    b = CircuitBuilder()
    ch_t = RecursiveChallenger(b)
    ch_n = Challenger()
    elems = [_rand() for _ in range(5)]
    cap = [[_rand() for _ in range(4)] for _ in range(2)]
    ts = [b.add_virtual_target() for _ in elems]
    cap_ts = [[b.add_virtual_target() for _ in d] for d in cap]
    for t in ts:
        ch_t.observe_element(t)
    ch_t.observe_cap(cap_ts)
    c1_t = ch_t.get_challenge()
    ext_t = ch_t.get_extension_challenge()
    ch_t.observe_element(ts[0])
    c2_t = ch_t.get_challenge()

    for v in elems:
        ch_n.observe_element(v)
    ch_n.observe_cap(cap)
    c1_n = ch_n.get_challenge()
    ext_n = ch_n.get_extension_challenge()
    ch_n.observe_element(elems[0])
    c2_n = ch_n.get_challenge()

    pw = Witness()
    for t, v in zip(ts, elems):
        pw.set_target(t, v)
    for dt, dv in zip(cap_ts, cap):
        for t, v in zip(dt, dv):
            pw.set_target(t, v)
    values = run_circuit(b, pw)
    assert values[c1_t.index] == c1_n
    assert (values[ext_t.c0.index], values[ext_t.c1.index]) == (ext_n.c0, ext_n.c1)
    assert values[c2_t.index] == c2_n


def test_ext_ops_match_glext():
    b = CircuitBuilder()
    ops = ExtOps(b)
    xv = GLExt(_rand(), _rand())
    yv = GLExt(_rand(), _rand())
    xt = ExtTarget(b.add_virtual_target(), b.add_virtual_target())
    yt = ExtTarget(b.add_virtual_target(), b.add_virtual_target())
    m = ops.mul(xt, yt)
    i = ops.inverse(xt)
    e = ops.exp_const(xt, 257)
    ma = ops.mul_add(xt, yt, xt)
    pw = Witness()
    for t, v in ((xt.c0, xv.c0), (xt.c1, xv.c1), (yt.c0, yv.c0), (yt.c1, yv.c1)):
        pw.set_target(t, v)
    values = run_circuit(b, pw)

    def get(t):
        return GLExt(values[t.c0.index], values[t.c1.index])

    assert get(m) == xv * yv
    assert get(i) == xv.inv()
    assert get(e) == xv.exp(257)
    assert get(ma) == xv * yv + xv


def test_split_le_and_random_access():
    b = CircuitBuilder()
    v = int(RNG.integers(0, 1 << 40))
    t = b.add_virtual_target()
    bits = split_le(b, t, 64)
    items = [b.constant(_rand()) for _ in range(8)]
    sel = random_access(b, bits[:3], items)
    pw = Witness()
    pw.set_target(t, v)
    values = run_circuit(b, pw)
    assert [values[x.index] for x in bits] == [(v >> i) & 1 for i in range(64)]
    assert values[sel.index] == values[items[v & 7].index]


@pytest.fixture(scope="module")
def demo_proof():
    stark = demo.demo_stark()
    trace, ctl_values = demo.demo_trace(np.random.default_rng(21))
    proof = prove_mod.prove(stark, trace, ctl_values, RECURSION_CONFIG)
    verify_mod.verify(stark, proof, ctl_values, RECURSION_CONFIG)
    return stark, proof, ctl_values


def _build_verifier(cb, sv, stark, degree_bits, ctl_values, config):
    b = cb.CircuitBuilder()
    proof_t = sv.add_virtual_stark_proof(b, stark, degree_bits, config)
    ctl_ts = {
        k: [[b.add_virtual_target() for _ in row] for row in rows]
        for k, rows in ctl_values.items()
    }
    sv.verify_stark_proof_circuit(b, stark, proof_t, ctl_ts, config)
    return b, proof_t, ctl_ts


def _set_witness(proof_t, proof, ctl_ts, ctl_values):
    pw = Witness()
    for k, v in set_stark_proof_target(proof_t, proof).items():
        pw.values[k] = v
    for key, rows_t in ctl_ts.items():
        for row_t, row_v in zip(rows_t, ctl_values[key]):
            for t, v in zip(row_t, row_v):
                pw.set_target(t, int(v) % gl.P)
    return pw


class _Port:
    CircuitBuilder = CircuitBuilder
    add_virtual_stark_proof = staticmethod(add_virtual_stark_proof)
    verify_stark_proof_circuit = staticmethod(verify_stark_proof_circuit)


def test_verifier_circuit_matches_jax(demo_proof):
    stark, proof, ctl_values = demo_proof
    b, _, _ = _build_verifier(_Port, _Port, stark, proof.degree_bits, ctl_values,
                              RECURSION_CONFIG)
    jb, _, _ = _build_verifier(jbuilder, jsv, jdemo.demo_stark(), proof.degree_bits,
                               ctl_values, JStarkConfig(**CONFIG_FIELDS))
    assert b.poseidon_ops
    assert recorded(b) == recorded(jb)


def test_recursive_verifier_accepts_port_proof(demo_proof):
    stark, proof, ctl_values = demo_proof
    b, proof_t, ctl_ts = _build_verifier(_Port, _Port, stark, proof.degree_bits, ctl_values,
                                         RECURSION_CONFIG)
    run_circuit(b, _set_witness(proof_t, proof, ctl_ts, ctl_values))


@pytest.mark.parametrize("tamper", ["opening", "ctl_value"])
def test_recursive_verifier_rejects_tampering(demo_proof, tamper):
    stark, proof, ctl_values = demo_proof
    b, proof_t, ctl_ts = _build_verifier(_Port, _Port, stark, proof.degree_bits, ctl_values,
                                         RECURSION_CONFIG)
    circuit = b.build()
    if tamper == "opening":
        # a tampered opening value -> constraint or generator conflict
        bad = prove_mod.Proof(**vars(proof))
        bad.openings = prove_mod.Openings(**vars(proof.openings))
        bad.openings.trace_zeta = list(proof.openings.trace_zeta)
        bad.openings.trace_zeta[0] = bad.openings.trace_zeta[0] + GLExt(1)
        pw = _set_witness(proof_t, bad, ctl_ts, ctl_values)
    else:
        # claimed circuit I/O != proven trace I/O
        bad_ctl = {k: [list(r) for r in rows] for k, rows in ctl_values.items()}
        bad_ctl[0][0][0] = (bad_ctl[0][0][0] + 1) % gl.P
        pw = _set_witness(proof_t, proof, ctl_ts, bad_ctl)
    with pytest.raises(ValueError):
        circuit.check(circuit.generate_witness(pw, device="cpu"), device="cpu")
