"""The port's twin of tests/test_unreduced_inputs.py: UNREDUCED
(lazily-reduced, more than 8-limb) values through every hook op kind.

`FqTarget.is_square` once passed its lazily-reduced receiver (a 17-limb
product) straight into the hook and `build()` crashed in the ToU16 resplit;
the hook entry points canonicalise (`take_mod`) before recording.  Here an
unreduced Fq, G1 and G2 go through fq_exp, is_square, g1_scalar_mul and
g2_scalar_mul in both packages from one seed, with the fake backend
(`prove_starks = False`, as the original): the recorded circuits and the
witnesses must be equal, the port's `check` must accept its witness, and
the outputs must equal the native oracle's.
"""

import numpy as np

from plonky2_bn254_tpu import circuit as jckt
from plonky2_bn254_tpu.bn254 import oracle as joracle
from plonky2_bn254_tpu.circuit import builder_ops as jbuilder_ops
from plonky2_bn254_tpu.circuit.curves import G1Target as JG1Target, G2Target as JG2Target
from plonky2_bn254_tpu.circuit.fq import FqTarget as JFqTarget
from plonky2_bn254_tpu_torch import circuit as ckt
from plonky2_bn254_tpu_torch.bn254 import oracle, params
from plonky2_bn254_tpu_torch.circuit import builder_ops
from plonky2_bn254_tpu_torch.circuit.curves import G1Target, G2Target
from plonky2_bn254_tpu_torch.circuit.fq import FqTarget
from test_torch_circuit import recorded

SEED = 41


def _build(c, o, ops, Fq, G1, G2, rng):
    """The original test's circuit on one package: (builder, witness, the
    checks of its outputs against the native oracle)."""
    b = c.CircuitBuilder()
    hook = ops.get_bn254_hook(b)
    hook.prove_starks = False
    pw = c.Witness()

    xv, yv = o.random_fq(rng), o.random_fq(rng)
    x = Fq.new_unchecked(b)
    y = Fq.new_unchecked(b)
    prod = x.mul(b, y)  # unreduced: 16 u32 limbs, mod_taken=False
    assert not prod.mod_taken and prod.value.num_limbs == 16
    e = ops.fq_exp(b, 5, prod)
    flag = prod.is_square(b)  # the 17-limb receiver

    one = Fq.one(b)
    g1 = G1.new_unchecked(b)
    g1o = G1.new_unchecked(b)
    g1_lazy = G1(g1.x.mul(b, one), g1.y.mul(b, one))
    assert not g1_lazy.x.mod_taken
    o1 = ops.g1_scalar_mul(b, 3, g1_lazy, g1o)
    g2 = G2.new_unchecked(b)
    g2o = G2.new_unchecked(b)
    o2 = ops.g2_scalar_mul(b, 3, g2, g2o)

    x.set_witness(pw, xv)
    y.set_witness(pw, yv)
    p1, p1o = o.random_g1(rng), o.random_g1(rng)
    p2, p2o = o.random_g2(rng), o.random_g2(rng)
    g1.set_witness(pw, p1)
    g1o.set_witness(pw, p1o)
    g2.set_witness(pw, p2)
    g2o.set_witness(pw, p2o)

    def want(values):
        pv = xv * yv % params.P
        assert e.get_witness(values) == pow(pv, 5, params.P)
        assert values[flag.index] == (1 if pow(pv, (params.P - 1) // 2, params.P) == 1 else 0)
        assert o1.get_witness(values) == oracle.g1_add(oracle.g1_mul(p1, 3), p1o)
        assert o2.get_witness(values) == oracle.g2_add(oracle.g2_mul(p2, 3), p2o)

    return b, pw, want


def test_unreduced_inputs_every_op_kind_matches_jax():
    jb, jpw, jwant = _build(jckt, joracle, jbuilder_ops, JFqTarget, JG1Target, JG2Target,
                            np.random.default_rng(SEED))
    b, pw, want = _build(ckt, oracle, builder_ops, FqTarget, G1Target, G2Target,
                         np.random.default_rng(SEED))
    jcircuit, circuit = jb.build(), b.build()
    assert recorded(b) == recorded(jb)
    values = circuit.generate_witness(pw, device="cpu")
    jvalues = jcircuit.generate_witness(jpw)
    assert values == jvalues
    circuit.check(values, device="cpu")
    want(values)
    jwant(jvalues)
