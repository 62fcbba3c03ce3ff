"""Prover and verifier of the PyTorch port against the JAX package.

On the demo machines under TEST_CONFIG the port's `Proof` must equal the
JAX package's field by field, the JAX `verify` must accept the port's proof,
the port's `verify` must accept it, and corrupted traces, CTL values and
openings must be rejected (as tests/test_prover_toy.py does).  The slow tier
repeats the parity for the G1 machine at 4 ops and 2048 rows.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plonky2_bn254_tpu.field.extension import GLExt as JGLExt
from plonky2_bn254_tpu.prover import fri as jfri
from plonky2_bn254_tpu.prover import prove as jprove
from plonky2_bn254_tpu.prover import verify as jverify
from plonky2_bn254_tpu.prover.config import TEST_CONFIG as JTEST_CONFIG
from plonky2_bn254_tpu.starks import demo as jdemo
from plonky2_bn254_tpu_torch.field import goldilocks as gl
from plonky2_bn254_tpu_torch.field.extension import GLExt
from plonky2_bn254_tpu_torch.interop import proof_to_fields
from plonky2_bn254_tpu_torch.prover import fri
from plonky2_bn254_tpu_torch.prover import prove as prove_mod
from plonky2_bn254_tpu_torch.prover import verify as verify_mod
from plonky2_bn254_tpu_torch.prover.config import TEST_CONFIG
from plonky2_bn254_tpu_torch.starks import demo

torch.set_num_threads(2)

MACHINES = {
    "demo": (demo.demo_stark, demo.demo_trace, jdemo.demo_stark, jdemo.demo_trace),
    "keyed": (demo.keyed_demo_stark, demo.keyed_demo_trace,
              jdemo.keyed_demo_stark, jdemo.keyed_demo_trace),
}


def assert_fields_equal(a, b, path="proof"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_fields_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_fields_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def to_jax_proof(fields):
    """Rebuild the JAX package's Proof from `proof_to_fields` output."""
    ext = lambda vals: [JGLExt(c0, c1) for c0, c1 in vals]
    return jprove.Proof(
        degree_bits=fields["degree_bits"],
        trace_cap=fields["trace_cap"],
        aux_cap=fields["aux_cap"],
        quotient_cap=fields["quotient_cap"],
        openings=jprove.Openings(**{k: ext(v) for k, v in fields["openings"].items()}),
        fri=jfri.FriProof(
            layer_caps=fields["fri"]["layer_caps"],
            final_coeffs=ext(fields["fri"]["final_coeffs"]),
            pow_nonce=fields["fri"]["pow_nonce"],
            queries=None,
        ),
        query_indices=fields["query_indices"],
        query_initials=fields["query_initials"],
        fri_query_layers=[
            [jfri.FriLayerProof(group_values=lp["group_values"], path=lp["path"]) for lp in q]
            for q in fields["fri_query_layers"]
        ],
    )


@pytest.fixture(scope="module")
def proofs():
    """Per machine: (stark, trace, ctl values, port proof, JAX proof)."""
    out = {}
    for name, (mk, mk_trace, jmk, jmk_trace) in MACHINES.items():
        trace, ctl = mk_trace(np.random.default_rng(11))
        jtrace, _ = jmk_trace(np.random.default_rng(11))
        out[name] = (mk(), trace, ctl, prove_mod.prove(mk(), trace, ctl, TEST_CONFIG),
                     jprove.prove(jmk(), jtrace, ctl, JTEST_CONFIG), jmk())
    return out


@pytest.mark.parametrize("name", list(MACHINES))
def test_proof_equals_jax_field_by_field(proofs, name):
    _, _, _, tproof, jproof, _ = proofs[name]
    assert_fields_equal(proof_to_fields(tproof), proof_to_fields(jproof))


@pytest.mark.parametrize("name", list(MACHINES))
def test_jax_verify_accepts_port_proof(proofs, name):
    _, _, ctl, tproof, _, jstark = proofs[name]
    jverify.verify(jstark, to_jax_proof(proof_to_fields(tproof)), ctl, JTEST_CONFIG)


@pytest.mark.parametrize("name", list(MACHINES))
def test_port_verify_accepts(proofs, name):
    stark, _, ctl, tproof, jproof, _ = proofs[name]
    zeta = verify_mod.verify(stark, tproof, ctl, TEST_CONFIG)
    assert isinstance(zeta, GLExt)


def test_rejects_corrupted_trace_and_ctl(proofs):
    stark, trace, ctl, tproof, _, _ = proofs["demo"]
    # a trace cell off its constraint: double != 2v on one row
    bad = trace.clone()
    bad[17, 1] += 1
    with pytest.raises(verify_mod.VerificationError):
        verify_mod.verify(stark, prove_mod.prove(stark, bad, ctl, TEST_CONFIG), ctl, TEST_CONFIG)
    # claimed CTL I/O that does not match the trace
    bad_ctl = {0: [list(row) for row in ctl[0]]}
    bad_ctl[0][0][0] = (bad_ctl[0][0][0] + 1) % gl.P
    with pytest.raises(verify_mod.VerificationError):
        verify_mod.verify(stark, tproof, bad_ctl, TEST_CONFIG)


def test_rejects_tampered_opening_and_keyed_lookup(proofs):
    stark, trace, ctl, _, _, _ = proofs["demo"]
    proof = prove_mod.prove(stark, trace, ctl, TEST_CONFIG)
    proof.openings.trace_zeta[0] = proof.openings.trace_zeta[0] + GLExt(1)
    with pytest.raises(verify_mod.VerificationError):
        verify_mod.verify(stark, proof, ctl, TEST_CONFIG)
    kstark, ktrace, kctl, _, _, _ = proofs["keyed"]
    bad = ktrace.clone()
    bad[9, 1] += 1  # a looked-up value off the table function
    with pytest.raises(verify_mod.VerificationError):
        verify_mod.verify(kstark, prove_mod.prove(kstark, bad, kctl, TEST_CONFIG), kctl, TEST_CONFIG)


def test_filtered_keyed_lookup_matches_jax():
    """KeyedLookup with a filter column (the aux filter path).  The demo
    frequencies count every row, so this witness does not satisfy the
    filtered lookup and neither proof verifies; the provers must agree."""
    def filtered(s):
        # a new name: the JAX prover caches its stages by machine name
        return dataclasses.replace(s, name="keyed_demo_filtered",
                                   lookups=[dataclasses.replace(s.lookups[0], filters=(5,))])

    stark = filtered(demo.keyed_demo_stark())
    jstark = filtered(jdemo.keyed_demo_stark())
    trace, ctl = demo.keyed_demo_trace(np.random.default_rng(21))
    jtrace, _ = jdemo.keyed_demo_trace(np.random.default_rng(21))
    tproof = prove_mod.prove(stark, trace, ctl, TEST_CONFIG)
    jproof = jprove.prove(jstark, jtrace, ctl, JTEST_CONFIG)
    assert_fields_equal(proof_to_fields(tproof), proof_to_fields(jproof))


def test_fri_helpers_match_jax():
    for n_log in (8, 11, 16):
        assert fri.domain_shifts_and_sizes(n_log, TEST_CONFIG) == jfri.domain_shifts_and_sizes(
            n_log, JTEST_CONFIG)
    np.testing.assert_array_equal(fri._inv_point_pows(8, 2, 7), jfri._inv_point_pows(8, 2, 7))
    vals = np.random.default_rng(4).integers(0, gl.P, (4, 2), dtype=np.uint64)
    beta = (123456789, 987654321)
    got = fri.h_fold_group(vals, 11, GLExt(*beta), 2)
    want = jfri.h_fold_group(vals, 11, JGLExt(*beta), 2)
    assert (got.c0, got.c1) == (want.c0, want.c1)


@pytest.mark.slow
def test_g1_proof_equals_jax_field_by_field():
    """G1 machine at 4 ops and 2048 rows.  Fewer than 2^16 rows cannot
    satisfy the range-counter constraint, so neither proof verifies; the
    two provers must still agree bit for bit."""
    from plonky2_bn254_tpu.starks.table import g1_scalar_mul_stark as jg1_stark
    from plonky2_bn254_tpu_torch.bn254 import oracle
    from plonky2_bn254_tpu_torch.starks import g1_scalar_mul
    from plonky2_bn254_tpu_torch.starks.table import g1_scalar_mul_stark

    rng = np.random.default_rng(5)
    inputs = [(int(rng.integers(1, 1 << 63)) << 180 | int(rng.integers(0, 1 << 63)),
               oracle.random_g1(rng), oracle.random_g1(rng), t) for t in range(4)]
    trace = g1_scalar_mul.generate_trace(inputs, min_rows=2048)
    ctl = g1_scalar_mul.generate_ctl_values(inputs)
    tproof = prove_mod.prove(g1_scalar_mul_stark(), trace, ctl, TEST_CONFIG)
    jtrace = jnp.asarray(trace.numpy().view(np.uint64))
    jproof = jprove.prove(jg1_stark(), jtrace, ctl, JTEST_CONFIG)
    assert_fields_equal(proof_to_fields(tproof), proof_to_fields(jproof))
