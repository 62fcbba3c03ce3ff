"""FqTarget: BN254 base field gadget over 8x u32 limbs with lazy reduction.

Copy of `plonky2_bn254_tpu/circuit/fq.py`: host Python on ints, which
records the same targets and constraints as the original (tests/test_torch_circuit.py
holds the two packages' circuits equal).

Rebuild of the reference crate's src/fields/fq.rs:26-388: `mod_taken` tracks
whether the value is known reduced; add/sub/mul work on unreduced BigUints
and `take_mod` performs the nondeterministic div_rem reduction; inv and
sqrt_with_sgn are hint-based with algebraic checks; is_square routes
through the FqExp STARK path (builder_ops.fq_exp) exactly like the
reference's Legendre-symbol gadget (fq.rs:283-296).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..bn254 import oracle, params
from ..field import goldilocks as gl
from . import biguint as bu
from .builder import CircuitBuilder, Constraint, Generator, Target

NUM_MODULUS_LIMBS = 8
P = params.P


@dataclass
class FqTarget:
    value: bu.BigUintTarget
    mod_taken: bool

    # -- construction ----------------------------------------------------

    @staticmethod
    def modulus() -> int:
        return P

    @staticmethod
    def num_modulus_limbs() -> int:
        return NUM_MODULUS_LIMBS

    @staticmethod
    def from_value(value: bu.BigUintTarget, mod_taken: bool) -> "FqTarget":
        return FqTarget(value, mod_taken)

    @staticmethod
    def new_unchecked(builder: CircuitBuilder) -> "FqTarget":
        return FqTarget(
            bu.add_virtual_biguint_target(builder, NUM_MODULUS_LIMBS), False
        )

    @staticmethod
    def new_checked(builder: CircuitBuilder) -> "FqTarget":
        t = FqTarget.new_unchecked(builder)
        valid = t.is_valid(builder)
        builder.connect(valid, builder.one())
        return FqTarget(t.value, True)

    @staticmethod
    def zero(builder: CircuitBuilder) -> "FqTarget":
        return FqTarget.constant(builder, 0)

    @staticmethod
    def one(builder: CircuitBuilder) -> "FqTarget":
        return FqTarget.constant(builder, 1)

    @staticmethod
    def constant(builder: CircuitBuilder, value: int) -> "FqTarget":
        v = bu.constant_biguint(builder, value % P)
        pad = NUM_MODULUS_LIMBS - v.num_limbs
        if pad > 0:
            v = bu.BigUintTarget(v.limbs + [builder.zero()] * pad)
        return FqTarget(v, True)

    def to_vec(self):
        return self.value.to_vec()

    @staticmethod
    def from_slice(targets) -> "FqTarget":
        assert len(targets) == NUM_MODULUS_LIMBS
        return FqTarget(bu.BigUintTarget(list(targets)), True)

    def set_witness(self, pw, value: int):
        self.value.set_witness(pw, value % P)

    def get_witness(self, values) -> int:
        return self.value.get_witness(values) % P

    # -- predicates ------------------------------------------------------

    def is_valid(self, builder: CircuitBuilder) -> Target:
        p_minus_1 = bu.constant_biguint(builder, P - 1)
        return bu.cmp_biguint(builder, self.value, p_minus_1)

    def is_zero(self, builder: CircuitBuilder) -> Target:
        t = self.take_mod(builder)
        flags = [bu._is_zero(builder, l) for l in t.value.limbs]
        acc = flags[0]
        for f in flags[1:]:
            acc = builder.mul(acc, f)
        return acc

    def is_equal(self, builder: CircuitBuilder, other: "FqTarget") -> Target:
        return self.sub(builder, other).is_zero(builder)

    def sgn(self, builder: CircuitBuilder) -> Target:
        """RFC-9380 sgn0: parity of the canonical representative (fq.rs:259)."""
        t = self.take_mod(builder)
        limb0 = t.value.limbs[0]
        bit = builder.add_virtual_target()
        half = builder.add_virtual_target()
        builder.assert_bool(bit)
        bu.range_check(builder, half, 31)
        # limb0 = 2*half + bit
        builder.constraints.append(
            Constraint(
                [
                    (2, [half.index]),
                    (1, [bit.index]),
                    (gl.P - 1, [limb0.index]),
                ],
                tag="sgn",
            )
        )
        builder.add_generator(
            Generator(
                [limb0.index],
                [bit.index, half.index],
                lambda w, l=limb0, b=bit, h=half: {
                    b.index: w[l.index] & 1,
                    h.index: w[l.index] >> 1,
                },
                "sgn",
            )
        )
        return bit

    # -- arithmetic ------------------------------------------------------

    def take_mod(self, builder: CircuitBuilder) -> "FqTarget":
        if self.mod_taken:
            return self
        _, r = bu.div_rem_biguint(builder, self.value, P)
        return FqTarget(r, True)

    def add(self, builder: CircuitBuilder, other: "FqTarget") -> "FqTarget":
        return FqTarget(bu.add_biguint(builder, self.value, other.value), False)

    def neg(self, builder: CircuitBuilder) -> "FqTarget":
        """-self (mod p) computed as (k*p - self) for safe headroom.

        k = ceil((2^(32n) - 1) / p) guarantees k*p >= x for EVERY n-limb
        value x, including fully unreduced 16-limb products (the reference
        instead reduces first, fq.rs:164-168; k = p<<(32n-254) would
        underflow at n=16, since k*p ~ 2^511.6 < 2^512 - 1)."""
        n_bits = 32 * self.value.num_limbs
        k = ((1 << n_bits) - 1 + P - 1) // P
        k_p = bu.constant_biguint(builder, k * P)
        return FqTarget(bu.sub_biguint(builder, k_p, self.value), False)

    def sub(self, builder: CircuitBuilder, other: "FqTarget") -> "FqTarget":
        return self.add(builder, other.neg(builder))

    def mul(self, builder: CircuitBuilder, other: "FqTarget") -> "FqTarget":
        return FqTarget(bu.mul_biguint(builder, self.value, other.value), False)

    def mul_constant_u32(self, builder: CircuitBuilder, c: int) -> "FqTarget":
        cb = bu.constant_biguint(builder, c)
        return FqTarget(bu.mul_biguint(builder, self.value, cb), False)

    def select(self, builder: CircuitBuilder, other: "FqTarget", flag: Target) -> "FqTarget":
        """flag ? self : other (reference select semantics, fq.rs:215)."""
        a, b = bu.pad_biguints(builder, self.value, other.value)
        limbs = [
            builder.select(flag, x, y) for x, y in zip(a.limbs, b.limbs)
        ]
        return FqTarget(bu.BigUintTarget(limbs), self.mod_taken and other.mod_taken)

    def connect(self, builder: CircuitBuilder, other: "FqTarget"):
        a = self.take_mod(builder)
        b = other.take_mod(builder)
        bu.connect_biguint(builder, a.value, b.value)

    def connect_conditional(self, builder: CircuitBuilder, other: "FqTarget", flag: Target):
        """connect iff flag (fq.rs:228): flag * (a - b) == 0 per limb."""
        a = self.take_mod(builder)
        b = other.take_mod(builder)
        av, bv = bu.pad_biguints(builder, a.value, b.value)
        for x, y in zip(av.limbs, bv.limbs):
            d = builder.sub(x, y)
            builder.assert_zero(builder.mul(flag, d))

    def inv(self, builder: CircuitBuilder) -> "FqTarget":
        """Hint inverse with x * out = 1 - is_zero check (fq.rs:242)."""
        out = FqTarget.new_checked(builder)
        x = self.take_mod(builder)
        is_zero = x.is_zero(builder)

        def run(w, x=x, out=out):
            v = x.get_witness(w)
            res = {}
            inv_v = oracle.fq_inv(v)
            for i, t in enumerate(out.value.limbs):
                res[t.index] = (inv_v >> (32 * i)) & bu.LIMB_MASK
            return res

        builder.add_generator(
            Generator(
                [t.index for t in x.value.limbs],
                [t.index for t in out.value.limbs],
                run,
                "fq_inv",
            )
        )
        prod = x.mul(builder, out).take_mod(builder)
        one_minus = FqTarget.one(builder).sub(
            builder,
            FqTarget(
                bu.BigUintTarget([is_zero] + [builder.zero()] * 7), True
            ),
        ).take_mod(builder)
        bu.connect_biguint(builder, prod.value, one_minus.value)
        return out

    def sqrt_with_sgn(self, builder: CircuitBuilder, sgn: Target) -> "FqTarget":
        """Hint sqrt with sqrt^2 = x and sgn(sqrt) = sgn checks (fq.rs:268)."""
        out = FqTarget.new_checked(builder)

        def run(w, x=self, out=out, sgn=sgn):
            v = x.get_witness(w)
            r = oracle.fq_sqrt(v)
            assert r is not None, "sqrt_with_sgn on non-square"
            if (r & 1) != w[sgn.index]:
                r = (-r) % P
            res = {}
            for i, t in enumerate(out.value.limbs):
                res[t.index] = (r >> (32 * i)) & bu.LIMB_MASK
            return res

        builder.add_generator(
            Generator(
                [t.index for t in self.value.limbs] + [sgn.index],
                [t.index for t in out.value.limbs],
                run,
                "fq_sqrt",
            )
        )
        sq = out.mul(builder, out).take_mod(builder)
        xm = self.take_mod(builder)
        bu.connect_biguint(builder, sq.value, xm.value)
        out_sgn = out.sgn(builder)
        builder.connect(out_sgn, sgn)
        return out

    def is_square(self, builder: CircuitBuilder) -> Target:
        """Legendre symbol x^((p-1)/2) via the FqExp STARK (fq.rs:283-296)."""
        from . import builder_ops

        exp = builder_ops.fq_exp(builder, (P - 1) // 2, self)
        one = FqTarget.one(builder)
        return exp.is_equal(builder, one)
