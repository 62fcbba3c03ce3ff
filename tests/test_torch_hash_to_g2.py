"""hash_to_g2 of the PyTorch port against the JAX package and the native
mirrors.

tests/test_circuit.py's hash_to_g2 tests on the port, fake backend (the
hook's ops take their native per-op witnesses): each circuit's outputs
equal the native mirror, and each circuit recorded by both packages from one
seed is the same (targets, templates, constraints, range checks, Poseidon
ops, generators; `recorded` of test_torch_circuit.py).  map_to_g2 blinds
its cofactor multiplication with an unseeded random offset, so there only
the recorded circuit and the output compare; hash_to_fq2's whole witness
equals JAX's.  The real backend (the hook proving its fq_exp and
g2_scalar_mul batches) is slow tier, as tests/test_hash_to_g2_real.py.
"""

import numpy as np
import pytest

from plonky2_bn254_tpu import circuit as jckt
from plonky2_bn254_tpu.bn254 import oracle as joracle
from plonky2_bn254_tpu.circuit import hash_to_g2 as jh2g
from plonky2_bn254_tpu_torch import circuit as ckt
from plonky2_bn254_tpu_torch.bn254 import oracle
from plonky2_bn254_tpu_torch.circuit import hash_to_g2 as h2g
from test_torch_circuit import recorded

SEED = 170


def test_native_mirrors_equal_jax():
    rng = np.random.default_rng(SEED)
    for _ in range(2):
        inputs = [int(v) for v in rng.integers(0, 1 << 60, size=int(rng.integers(1, 9)))]
        assert h2g.hash_to_fq2(inputs) == jh2g.hash_to_fq2(inputs)
        u = (oracle.random_fq(rng), oracle.random_fq(rng))
        assert h2g.map_to_g2(u) == jh2g.map_to_g2(u)
    assert h2g._sw_constants() == jh2g._sw_constants()
    assert h2g.COFACTOR == jh2g.COFACTOR


def _hash_to_fq2(c, h, o, rng):
    inputs = [int(rng.integers(0, 1 << 60)) for _ in range(5)]
    b = c.CircuitBuilder()
    ts = [b.add_virtual_target() for _ in inputs]
    out = h.hash_to_fq2_circuit(b, ts)
    pw = c.Witness()
    for t, v in zip(ts, inputs):
        pw.set_target(t, v)
    return b, pw, out, h.hash_to_fq2(inputs)


def _map_to_g2(c, h, o, rng):
    uv = (o.random_fq(rng), o.random_fq(rng))
    b = c.CircuitBuilder()
    c.get_bn254_hook(b).prove_starks = False
    u = c.Fq2Target.new_unchecked(b)
    out = h.map_to_g2_circuit(b, u)
    pw = c.Witness()
    u.set_witness(pw, uv)
    return b, pw, out, h.map_to_g2(uv)


def _hash_to_g2(c, h, o, rng):
    inputs = [int(rng.integers(0, 1 << 60)) for _ in range(4)]
    b = c.CircuitBuilder()
    c.get_bn254_hook(b).prove_starks = False
    ts = [b.add_virtual_target() for _ in inputs]
    out = h.hash_to_g2_circuit(b, ts)
    pw = c.Witness()
    for t, v in zip(ts, inputs):
        pw.set_target(t, v)
    return b, pw, out, h.hash_to_g2(inputs)


CASES = {"hash_to_fq2": _hash_to_fq2, "map_to_g2": _map_to_g2, "hash_to_g2": _hash_to_g2}


@pytest.mark.parametrize("kind", list(CASES))
def test_circuit_equals_native_and_jax(kind):
    """The fake-backend circuit's output equals the native mirror; the
    recorded circuit equals JAX's; `check` accepts the witness."""
    jb, jpw, _, jwant = CASES[kind](jckt, jh2g, joracle, np.random.default_rng(SEED))
    b, pw, out, want = CASES[kind](ckt, h2g, oracle, np.random.default_rng(SEED))
    assert want == jwant
    jcircuit, circuit = jb.build(), b.build()
    assert recorded(b) == recorded(jb)
    values, _ = circuit.prove(pw, device="cpu")  # witness + check
    assert out.get_witness(values) == want
    if kind == "hash_to_fq2":
        assert values == jcircuit.generate_witness(jpw)


@pytest.mark.slow
def test_map_to_g2_real_backend():
    """tests/test_hash_to_g2_real.py on the port: two fq_exp ops (the
    Legendre candidates) and one g2_scalar_mul (the blinded cofactor) proved
    by the hook on the CPU and bound in-circuit, at the hook config there."""
    from plonky2_bn254_tpu_torch.prover.config import StarkConfig

    rng = np.random.default_rng(SEED)
    uv = (oracle.random_fq(rng), oracle.random_fq(rng))
    b = ckt.CircuitBuilder()
    hook = ckt.get_bn254_hook(b)
    hook.stark_config = StarkConfig(num_challenges=2, rate_bits=1, cap_height=1,
                                    proof_of_work_bits=8, num_query_rounds=4, arity_bits=2,
                                    final_poly_degree_bits=3)
    assert hook.prove_starks
    u = ckt.Fq2Target.new_unchecked(b)
    out = h2g.map_to_g2_circuit(b, u)
    pw = ckt.Witness()
    u.set_witness(pw, uv)
    values, proofs = b.build().prove(pw, device="cpu")
    assert out.get_witness(values) == h2g.map_to_g2(uv)
    assert {"fq_exp", "g2_scalar_mul"} <= set(proofs["bn254"])
