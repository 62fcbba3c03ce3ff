"""Hash-to-G2: Poseidon challenger -> Fq2 -> SW map -> cofactor clearing.

Port of `plonky2_bn254_tpu/circuit/hash_to_g2.py` (host Python on the port's
`Challenger`, `RecursiveChallenger`, `Fq2Target`, `G2Target` and hook):
  * hash_to_fq2: squeeze 2x16 felts, keep the low 32 bits of each
    (uniformity), assemble a BigUint, reduce mod p;
  * map_to_g2: Shallue-van de Woestijne per RFC 9380 §6.6.1 with
    precomputed Fq2 constants, 3 candidate x's selected by is_square
    (FqExp STARK Legendre calls through the hook's `fq_exp`), y via
    sqrt_with_sgn(sgn(u));
  * cofactor multiplication via the batched g2_scalar_mul STARK with a
    random blinding offset.
Native mirrors (`hash_to_fq2`, `map_to_g2`, `hash_to_g2`) for the tests.
"""

from __future__ import annotations

from typing import List

from ..bn254 import oracle, params
from ..field import goldilocks as gl
from ..prover.challenger import Challenger
from . import biguint as bu
from . import builder_ops
from .builder import CircuitBuilder, Constraint, Generator, Target
from .curves import G2Target
from .fq import NUM_MODULUS_LIMBS, FqTarget
from .fq2 import Fq2Target

COFACTOR = params.G2_COFACTOR


# ---------------------------------------------------------------------------
# SW-map constants (host-computed; reference computes them with arkworks)
# ---------------------------------------------------------------------------


def _sw_constants():
    Z = (1, 0)
    gz = G2Target.g(Z)  # g(1) = 1 + b
    half_inv = oracle.fq_inv(2)
    neg_z_by_two = oracle.fq2_mul_scalar(oracle.fq2_neg(Z), half_inv)
    # tv4 = sqrt(-gz * 3 * z^2)
    tv4 = oracle.fq2_sqrt(oracle.fq2_neg(oracle.fq2_mul_scalar(gz, 3)))
    assert tv4 is not None
    # tv6 = -4 * gz / (3 * z^2)
    tv6 = oracle.fq2_mul(
        oracle.fq2_mul_scalar(oracle.fq2_neg(gz), 4),
        oracle.fq2_inv((3, 0)),
    )
    return Z, gz, neg_z_by_two, tv4, tv6


# ---------------------------------------------------------------------------
# Native mirrors (tests)
# ---------------------------------------------------------------------------


def hash_to_fq2(inputs: List[int]):
    """Native mirror (hash_to_g2.rs:76-87): two 512-bit squeezes mod p."""
    ch = Challenger()
    ch.observe_elements(inputs)
    c0_felts = ch.get_n_challenges(2 * NUM_MODULUS_LIMBS)
    c0 = _felts_to_int(c0_felts) % params.P
    c1_felts = ch.get_n_challenges(2 * NUM_MODULUS_LIMBS)
    c1 = _felts_to_int(c1_felts) % params.P
    return (c0, c1)


def _felts_to_int(felts: List[int]) -> int:
    # keep only the low 32 bits of each felt (uniformity)
    return sum((f & 0xFFFFFFFF) << (32 * i) for i, f in enumerate(felts))


def map_to_g2(u):
    """Native SW map mirror (hash_to_g2.rs:113-148)."""
    Z, gz, neg_z_by_two, tv4, tv6 = _sw_constants()
    one = (1, 0)
    tv1 = oracle.fq2_mul(oracle.fq2_mul(u, u), gz)
    tv2 = oracle.fq2_add(one, tv1)
    tv1 = oracle.fq2_sub(one, tv1)
    tv3 = oracle.fq2_inv(oracle.fq2_mul(tv1, tv2))
    tv5 = oracle.fq2_mul(oracle.fq2_mul(oracle.fq2_mul(u, tv1), tv3), tv4)
    x1 = oracle.fq2_sub(neg_z_by_two, tv5)
    x2 = oracle.fq2_add(neg_z_by_two, tv5)
    t = oracle.fq2_mul(oracle.fq2_mul(tv2, tv2), tv3)
    x3 = oracle.fq2_add(Z, oracle.fq2_mul(tv6, oracle.fq2_mul(t, t)))
    if oracle.fq2_is_square(G2Target.g(x1)):
        x = x1
    elif oracle.fq2_is_square(G2Target.g(x2)):
        x = x2
    else:
        x = x3
    y = oracle.fq2_sqrt(G2Target.g(x))
    if oracle.fq2_sgn(u) != oracle.fq2_sgn(y):
        y = oracle.fq2_neg(y)
    return oracle.g2_mul((x, y), COFACTOR)


def hash_to_g2(inputs: List[int]):
    return map_to_g2(hash_to_fq2(inputs))


# ---------------------------------------------------------------------------
# Circuit versions
# ---------------------------------------------------------------------------


def hash_to_fq2_circuit(builder: CircuitBuilder, inputs: List[Target]) -> Fq2Target:
    from .poseidon_gadget import RecursiveChallenger

    ch = RecursiveChallenger(builder)
    ch.observe_elements(inputs)
    c0 = _squeeze_fq(builder, ch)
    c1 = _squeeze_fq(builder, ch)
    return Fq2Target.from_value(c0, c1)


def _squeeze_fq(builder: CircuitBuilder, ch) -> FqTarget:
    felts = ch.get_n_challenges(2 * NUM_MODULUS_LIMBS)
    limbs = [_low_32(builder, f) for f in felts]
    return FqTarget.from_value(bu.BigUintTarget(limbs), False).take_mod(builder)


def _low_32(builder: CircuitBuilder, t: Target) -> Target:
    """split_low_high(t, 32, 64) keeping the low u32 (hash_to_g2.rs:246)."""
    lo = builder.add_virtual_target()
    hi = builder.add_virtual_target()
    bu.range_check(builder, lo, 32)
    bu.range_check(builder, hi, 32)
    builder.constraints.append(
        Constraint(
            [
                (1, [lo.index]),
                (1 << 32, [hi.index]),
                (gl.P - 1, [t.index]),
            ],
            tag="split_low_high",
        )
    )
    builder.add_generator(
        Generator(
            [t.index],
            [lo.index, hi.index],
            lambda w, t=t, lo=lo, hi=hi: {
                lo.index: w[t.index] & 0xFFFFFFFF,
                hi.index: w[t.index] >> 32,
            },
            "split_low_high",
        )
    )
    return lo


def map_to_g2_circuit(builder: CircuitBuilder, u: Fq2Target) -> G2Target:
    Z, gz_v, neg_z_by_two, tv4_v, tv6_v = _sw_constants()
    z = Fq2Target.constant(builder, Z)
    gz = Fq2Target.constant(builder, gz_v)
    tv4 = Fq2Target.constant(builder, tv4_v)
    tv6 = Fq2Target.constant(builder, tv6_v)
    neg_two_by_z = Fq2Target.constant(builder, neg_z_by_two)
    one = Fq2Target.one(builder)

    tv1 = u.mul(builder, u).mul(builder, gz).take_mod(builder)
    tv2 = one.add(builder, tv1).take_mod(builder)
    tv1 = one.sub(builder, tv1).take_mod(builder)
    tv3 = tv1.mul(builder, tv2).take_mod(builder).inv(builder)
    tv5 = (
        u.mul(builder, tv1)
        .take_mod(builder)
        .mul(builder, tv3)
        .take_mod(builder)
        .mul(builder, tv4)
        .take_mod(builder)
    )
    x1 = neg_two_by_z.sub(builder, tv5).take_mod(builder)
    x2 = neg_two_by_z.add(builder, tv5).take_mod(builder)
    t223 = tv2.mul(builder, tv2).take_mod(builder).mul(builder, tv3).take_mod(builder)
    t223_sq = t223.mul(builder, t223).take_mod(builder)
    x3 = z.add(builder, tv6.mul(builder, t223_sq).take_mod(builder)).take_mod(builder)

    gx1 = G2Target.g_circuit(builder, x1).take_mod(builder)
    gx2 = G2Target.g_circuit(builder, x2).take_mod(builder)
    is_gx1_sq = gx1.is_square(builder)
    is_gx2_sq = gx2.is_square(builder)

    x1_or_x2 = x1.select(builder, x2, is_gx1_sq)
    # or(a,b) = a + b - ab
    ab = builder.mul(is_gx1_sq, is_gx2_sq)
    a_plus_b = builder.add(is_gx1_sq, is_gx2_sq)
    either = builder.sub(a_plus_b, ab)
    x = x1_or_x2.select(builder, x3, either)

    gx = G2Target.g_circuit(builder, x).take_mod(builder)
    sgn_u = u.sgn(builder)
    y = gx.sqrt_with_sgn(builder, sgn_u)

    offset = G2Target.new_checked(builder)
    builder_ops.set_random_g2(builder, offset)
    output_offset = builder_ops.g2_scalar_mul(
        builder, COFACTOR, G2Target.from_value(x, y), offset
    )
    neg_offset = offset.neg(builder)
    return output_offset.add(builder, neg_offset)


def hash_to_g2_circuit(builder: CircuitBuilder, inputs: List[Target]) -> G2Target:
    u = hash_to_fq2_circuit(builder, inputs)
    return map_to_g2_circuit(builder, u)
