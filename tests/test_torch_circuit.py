"""The port's circuit gadget layer against the JAX package's.

Each gadget circuit is recorded by both packages from one seed: the targets,
the interned templates and their rows, the object constraints, the range
checks, the Poseidon ops, the public inputs and the generators must be equal,
and so must the witness the two fixpoints generate (exact: ints, `==`).  The
port's `check` (int64 tensors on the CPU here) must accept that witness and
reject it with one value flipped.
"""

import numpy as np
import pytest

from plonky2_bn254_tpu import circuit as jckt
from plonky2_bn254_tpu.bn254 import oracle as joracle
from plonky2_bn254_tpu.circuit import to_u16 as jto_u16
from plonky2_bn254_tpu.circuit.biguint import range_check as jrange_check
from plonky2_bn254_tpu_torch import circuit as ckt
from plonky2_bn254_tpu_torch.bn254 import oracle
from plonky2_bn254_tpu_torch.bn254.params import P
from plonky2_bn254_tpu_torch.circuit import to_u16
from plonky2_bn254_tpu_torch.circuit.biguint import range_check

SEED = 71


def _biguint(c, o, t, rc, rng):
    b = c.CircuitBuilder()
    x = c.add_virtual_biguint_target(b, 8)
    y = c.add_virtual_biguint_target(b, 8)
    s = c.add_biguint(b, x, y)
    d = c.sub_biguint(b, x, y)
    m = c.mul_biguint(b, x, y)
    le = c.cmp_biguint(b, x, y)
    q, r = c.div_rem_biguint(b, x, P)
    pw = c.Witness()
    xv = int(rng.integers(0, 1 << 63)) << 190 | 12345
    yv = int(rng.integers(0, 1 << 60)) << 150 | 7
    xv, yv = max(xv, yv), min(xv, yv)
    x.set_witness(pw, xv)
    y.set_witness(pw, yv)

    def want(v):
        assert s.get_witness(v) == xv + yv and d.get_witness(v) == xv - yv
        assert m.get_witness(v) == xv * yv and v[le.index] == 0
        assert (q.get_witness(v), r.get_witness(v)) == divmod(xv, P)

    return b, pw, want


def _fq(c, o, t, rc, rng):
    b = c.CircuitBuilder()
    x = c.FqTarget.new_unchecked(b)
    y = c.FqTarget.new_unchecked(b)
    add = x.add(b, y).take_mod(b)
    sub = x.sub(b, y).take_mod(b)
    mul = x.mul(b, y).take_mod(b)
    inv = x.inv(b)
    sgn = x.sgn(b)
    iz = x.is_zero(b)
    ie = x.is_equal(b, y)
    valid = x.is_valid(b)
    pw = c.Witness()
    xv, yv = o.random_fq(rng), o.random_fq(rng)
    x.set_witness(pw, xv)
    y.set_witness(pw, yv)

    def want(v):
        assert add.get_witness(v) == (xv + yv) % P and sub.get_witness(v) == (xv - yv) % P
        assert mul.get_witness(v) == xv * yv % P and inv.get_witness(v) == oracle.fq_inv(xv)
        assert (v[sgn.index], v[iz.index], v[ie.index], v[valid.index]) == (xv & 1, 0, 0, 1)

    return b, pw, want


def _fq2(c, o, t, rc, rng):
    b = c.CircuitBuilder()
    x = c.Fq2Target.new_unchecked(b)
    y = c.Fq2Target.new_unchecked(b)
    mul = x.mul(b, y).take_mod(b)
    inv = x.inv(b)
    sq = x.mul(b, x).take_mod(b)
    back = sq.sqrt_with_sgn(b, x.sgn(b))
    pw = c.Witness()
    xv = (o.random_fq(rng), o.random_fq(rng))
    yv = (o.random_fq(rng), o.random_fq(rng))
    x.set_witness(pw, xv)
    y.set_witness(pw, yv)

    def want(v):
        assert mul.get_witness(v) == oracle.fq2_mul(xv, yv)
        assert inv.get_witness(v) == oracle.fq2_inv(xv) and back.get_witness(v) == xv

    return b, pw, want


def _g1(c, o, t, rc, rng):
    pts = [o.random_g1(rng) for _ in range(2)]
    b = c.CircuitBuilder()
    a = c.G1Target.new_checked(b)
    e = c.G1Target.new_checked(b)
    added = a.add(b, e)
    doubled = a.add(b, a)
    neg = a.neg(b)
    pw = c.Witness()
    a.set_witness(pw, pts[0])
    e.set_witness(pw, pts[1])

    def want(v):
        assert added.get_witness(v) == oracle.g1_add(pts[0], pts[1])
        assert doubled.get_witness(v) == oracle.g1_add(pts[0], pts[0])
        assert neg.get_witness(v) == oracle.g1_neg(pts[0])

    return b, pw, want


def _g2(c, o, t, rc, rng):
    pts = [o.random_g2(rng) for _ in range(2)]
    b = c.CircuitBuilder()
    a = c.G2Target.new_checked(b)
    e = c.G2Target.new_checked(b)
    added = a.add(b, e)
    pw = c.Witness()
    a.set_witness(pw, pts[0])
    e.set_witness(pw, pts[1])

    def want(v):
        assert added.get_witness(v) == oracle.g2_add(pts[0], pts[1])

    return b, pw, want


def _to_u16(c, o, t, rc, rng):
    b = c.CircuitBuilder()
    x = c.FqTarget.new_unchecked(b)
    pt = c.G1Target.new_unchecked(b)
    halves = t.fq_to_u16(b, x) + t.g1_to_u16(b, pt)
    w = b.add_virtual_target()
    rc(b, w, 12)
    b.register_public_input(halves[0])
    b.register_public_input(w)
    pw = c.Witness()
    xv, pv = o.random_fq(rng), o.random_g1(rng)
    x.set_witness(pw, xv)
    pt.set_witness(pw, pv)
    pw.set_target(w, 4095)

    def want(v):
        words = [xv, pv[0], pv[1]]
        expect = [(wd >> (16 * i)) & 0xFFFF for wd in words for i in range(16)]
        assert [v[h.index] for h in halves] == expect

    return b, pw, want


def _hook_fake(c, o, t, rc, rng):
    """The BN254 ops recorded on the hook, witness from the native per-op
    generators (the reference's not-constrain-bn254-stark mode)."""
    b = c.CircuitBuilder()
    hook = c.get_bn254_hook(b)
    hook.prove_starks = False
    sx = c.add_virtual_biguint_target(b, 8)
    fx = c.FqTarget.new_unchecked(b)
    fq_out = c.fq_exp(b, sx, fx)
    g1x = c.G1Target.new_checked(b)
    g1o = c.G1Target.new_checked(b)
    g1_out = c.g1_scalar_mul(b, 7, g1x, g1o)
    g2x = c.G2Target.new_checked(b)
    g2o = c.G2Target.new_checked(b)
    g2_out = c.g2_scalar_mul(b, 5, g2x, g2o)
    pw = c.Witness()
    sv = int(rng.integers(1, 1 << 62)) << 150 | 3
    xv = o.random_fq(rng)
    sx.set_witness(pw, sv)
    fx.set_witness(pw, xv)
    p, po = o.random_g1(rng), o.random_g1(rng)
    g1x.set_witness(pw, p)
    g1o.set_witness(pw, po)
    q, qo = o.random_g2(rng), o.random_g2(rng)
    g2x.set_witness(pw, q)
    g2o.set_witness(pw, qo)

    def want(v):
        assert fq_out.get_witness(v) == pow(xv, sv, P)
        assert g1_out.get_witness(v) == oracle.g1_add(oracle.g1_mul(p, 7), po)
        assert g2_out.get_witness(v) == oracle.g2_add(oracle.g2_mul(q, 5), qo)

    return b, pw, want


def _msm(c, o, t, rc, rng):
    """g1_msm blinds its running sum with a random offset (an unseeded
    witness hint), so only its recorded circuit and its result compare."""
    b = c.CircuitBuilder()
    c.get_bn254_hook(b).prove_starks = False
    scalars = [c.add_virtual_biguint_target(b, 8) for _ in range(2)]
    points = [c.G1Target.new_checked(b) for _ in range(2)]
    out = c.g1_msm(b, scalars, points)
    pw = c.Witness()
    svs = [int(rng.integers(1, 1 << 62)) for _ in range(2)]
    pts = [o.random_g1(rng) for _ in range(2)]
    for s, v in zip(scalars, svs):
        s.set_witness(pw, v)
    for p, v in zip(points, pts):
        p.set_witness(pw, v)

    def want(v):
        acc = None
        for s, p in zip(svs, pts):
            acc = oracle.g1_add(acc, oracle.g1_mul(p, s))
        assert out.get_witness(v) == acc

    return b, pw, want


GADGETS = {
    "biguint": _biguint,
    "fq": _fq,
    "fq2": _fq2,
    "g1": _g1,
    "g2": _g2,
    "to_u16": _to_u16,
    "hook_fake": _hook_fake,
    "msm": _msm,
}


def recorded(b):
    """Everything a builder recorded, as plain python values."""
    return {
        "num_targets": b.num_targets,
        "templates": [(t.monomials, t.out_slot) for t in b.templates],
        "tpl_tids": list(b.tpl_tids),
        "tpl_rows": [list(r) for r in b.tpl_rows],
        "constraints": [([(c, list(i)) for c, i in x.monomials], x.tag) for x in b.constraints],
        "range_checks": list(getattr(b, "range_checks", [])),
        "poseidon_ops": [(list(i), list(o)) for i, o in b.poseidon_ops],
        "public_inputs": list(b.public_inputs),
        "generators": [(g.deps, g.outputs, g.name) for g in b.generators],
    }


@pytest.mark.parametrize("kind", list(GADGETS))
def test_gadget_circuit_matches_jax(kind):
    build = GADGETS[kind]
    jb, jpw, _ = build(jckt, joracle, jto_u16, jrange_check, np.random.default_rng(SEED))
    b, pw, want = build(ckt, oracle, to_u16, range_check, np.random.default_rng(SEED))
    jcircuit, circuit = jb.build(), b.build()
    assert recorded(b) == recorded(jb)

    values = circuit.generate_witness(pw, device="cpu")
    if kind != "msm":
        assert values == jcircuit.generate_witness(jpw)
    want(values)
    circuit.check(values, device="cpu")

    # flip the output wire of the last solvable templated row: that row's
    # constraint is `sum(other monomials) - out == 0`, so it must fail
    ri = max(i for i, tid in enumerate(b.tpl_tids) if b.templates[tid].out_slot is not None)
    out = b.tpl_rows[ri][b.templates[b.tpl_tids[ri]].out_slot]
    bad = dict(values)
    bad[out] = (bad[out] + 1) % ckt.builder.gl.P
    with pytest.raises(ValueError, match="violated"):
        circuit.check(bad, device="cpu")


def test_check_rejects_range_and_poseidon_violations():
    """`check`'s vectorized range checks and Poseidon ops name the first
    violation, as the JAX package's loops do."""
    from plonky2_bn254_tpu_torch.circuit import poseidon_gadget as pg

    b = ckt.CircuitBuilder()
    w = b.add_virtual_target()
    range_check(b, w, 12)
    ins = b.add_virtual_targets(12)
    outs = pg.permute_targets(b, ins)
    circuit = b.build()
    pw = ckt.Witness()
    pw.set_target(w, 4095)
    for i, t in enumerate(ins):
        pw.set_target(t, i)
    values = circuit.generate_witness(pw, device="cpu")
    circuit.check(values, device="cpu")
    with pytest.raises(ValueError, match=rf"range check violated: t{w.index} = 4096 >= 2\^12"):
        circuit.check({**values, w.index: 4096}, device="cpu")
    with pytest.raises(ValueError, match="poseidon op 0 violated"):
        circuit.check({**values, outs[3].index: 1}, device="cpu")
