"""The composed product through the port, against the JAX package (slow).

The 2-op `fq_exp` hook flow of tests/test_compose.py at its INNER_CONFIG:
both packages record the same circuit from one seed; the port proves the
inner FqExp batch (a 2^16-row trace on the CPU here) and injects it at
witness time, compiles the outer circuit and proves it with `prove_all`.
The port's recorded circuit, witness, constant columns and verifier key must
equal the JAX package's, the JAX `verify_outer` must accept the port's
proof, and the port's `verify_all` must accept it and reject a corrupted
public value.  The three-kinds flow runs on the card (tests/test_torch_cuda.py).
In tier-1, the production circuit of chip_smoke.py's compose path is recorded
by both packages and compared.
"""

import numpy as np
import pytest

from plonky2_bn254_tpu.bn254 import oracle as joracle
from plonky2_bn254_tpu.circuit import builder as jbuilder
from plonky2_bn254_tpu.circuit import builder_ops as jbuilder_ops
from plonky2_bn254_tpu.circuit import fq as jfq
from plonky2_bn254_tpu.circuit import outer as jouter
from plonky2_bn254_tpu.prover.config import StarkConfig as JStarkConfig
from plonky2_bn254_tpu.prover.config import TEST_CONFIG as JTEST_CONFIG
from plonky2_bn254_tpu_torch.bn254 import oracle, params
from plonky2_bn254_tpu_torch.circuit import builder, builder_ops, fq
from plonky2_bn254_tpu_torch.field import goldilocks as gl
from plonky2_bn254_tpu_torch.interop import outer_tables_to_numpy, proof_to_fields
from plonky2_bn254_tpu_torch.prover.config import TEST_CONFIG, StarkConfig
from plonky2_bn254_tpu_torch.prover.verify import VerificationError

from test_torch_circuit import recorded
from test_torch_prove import to_jax_proof

INNER = dict(num_challenges=2, rate_bits=1, cap_height=1, proof_of_work_bits=8,
             num_query_rounds=4, arity_bits=2, final_poly_degree_bits=3)


def _build(b_mod, ops_mod, fq_mod, o, config, seed=99):
    rng = np.random.default_rng(seed)
    b = b_mod.CircuitBuilder()
    hook = ops_mod.get_bn254_hook(b)
    hook.stark_config = config
    pw = b_mod.Witness()
    outs = []
    for _ in range(2):
        x_t = fq_mod.FqTarget.new_unchecked(b)
        s_v = int(rng.integers(1, 1 << 62)) << 150 | int(rng.integers(0, 1 << 62))
        x_v = o.random_fq(rng)
        outs.append((ops_mod.fq_exp(b, s_v, x_t), pow(x_v, s_v, params.P)))
        x_t.set_witness(pw, x_v)
    for t in outs[0][0].value.limbs:
        b.register_public_input(t)
    return b, pw, outs


@pytest.mark.slow
def test_compose_fq_exp_port_matches_jax():
    jb, jpw, _ = _build(jbuilder, jbuilder_ops, jfq, joracle, JStarkConfig(**INNER))
    b, pw, outs = _build(builder, builder_ops, fq, oracle, StarkConfig(**INNER))
    jcircuit, circuit = jb.build(), b.build()
    assert recorded(b) == recorded(jb)

    values = circuit.generate_witness(pw, device="cpu")
    assert values == jcircuit.generate_witness(jpw)
    for out_t, want in outs:
        assert out_t.get_witness(values) == want

    data = circuit.outer_data(device="cpu")
    jdata = jcircuit.outer_data()
    assert (data.n_log, data.n_wires, data.n_pos) == (jdata.n_log, jdata.n_wires, jdata.n_pos)
    const_np, vk_np = outer_tables_to_numpy(data.const_cols, data.vk_coeffs)
    np.testing.assert_array_equal(const_np, jdata.const_cols_np)
    np.testing.assert_array_equal(vk_np, np.asarray(jdata.vk_coeffs))

    proof, publics = circuit.prove_all(pw, TEST_CONFIG, device="cpu")
    assert sum(v << (32 * i) for i, v in enumerate(publics)) == outs[0][1]
    jouter.verify_outer(jdata, to_jax_proof(proof_to_fields(proof)), publics, JTEST_CONFIG)
    circuit.verify_all(proof, publics, TEST_CONFIG, device="cpu")
    bad = list(publics)
    bad[0] = (bad[0] + 1) % gl.P
    with pytest.raises(VerificationError):
        circuit.verify_all(proof, bad, TEST_CONFIG, device="cpu")


def test_production_compose_circuit_matches_jax():
    """The circuit chip_smoke.py's compose path records (two fq_exp ops from
    default_rng(123) at DEFAULT_CONFIG: the in-circuit recursive verifier of
    the 84-query inner proof) is the JAX package's, target for target.
    Recording only: no witness, no proof."""
    from plonky2_bn254_tpu.prover.config import DEFAULT_CONFIG as JDEFAULT
    from plonky2_bn254_tpu_torch.prover.config import DEFAULT_CONFIG

    b = _build(builder, builder_ops, fq, oracle, DEFAULT_CONFIG, seed=123)[0]
    jb = _build(jbuilder, jbuilder_ops, jfq, joracle, JDEFAULT, seed=123)[0]
    b.build(), jb.build()
    assert b.num_targets == jb.num_targets == 495_926
    assert len(b.poseidon_ops) == 11_859
    assert recorded(b) == recorded(jb)
