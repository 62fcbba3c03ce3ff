"""Fq2Target: quadratic extension gadget (c0 + c1*u, u^2 = -1).

Copy of `plonky2_bn254_tpu/circuit/fq2.py`: host Python on ints, which
records the same targets and constraints as the original (tests/test_torch_circuit.py
holds the two packages' circuits equal).

Rebuild of the reference crate's src/fields/fq2.rs:21-336: schoolbook mul
(4 Fq muls), RFC-9380 sgn parity rule, hint-based inv/sqrt with algebraic
checks.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..bn254 import oracle, params
from . import biguint as bu
from .builder import Generator, Target
from .fq import FqTarget

P = params.P


@dataclass
class Fq2Target:
    c0: FqTarget
    c1: FqTarget

    # -- construction ----------------------------------------------------

    @staticmethod
    def from_value(c0: FqTarget, c1: FqTarget) -> "Fq2Target":
        return Fq2Target(c0, c1)

    @staticmethod
    def new_unchecked(builder) -> "Fq2Target":
        return Fq2Target(FqTarget.new_unchecked(builder), FqTarget.new_unchecked(builder))

    @staticmethod
    def new_checked(builder) -> "Fq2Target":
        return Fq2Target(FqTarget.new_checked(builder), FqTarget.new_checked(builder))

    @staticmethod
    def constant(builder, value) -> "Fq2Target":
        return Fq2Target(
            FqTarget.constant(builder, value[0]), FqTarget.constant(builder, value[1])
        )

    @staticmethod
    def zero(builder) -> "Fq2Target":
        return Fq2Target.constant(builder, (0, 0))

    @staticmethod
    def one(builder) -> "Fq2Target":
        return Fq2Target.constant(builder, (1, 0))

    def to_vec(self):
        return self.c0.to_vec() + self.c1.to_vec()

    @staticmethod
    def from_slice(targets) -> "Fq2Target":
        h = len(targets) // 2
        return Fq2Target(FqTarget.from_slice(targets[:h]), FqTarget.from_slice(targets[h:]))

    def set_witness(self, pw, value):
        self.c0.set_witness(pw, value[0])
        self.c1.set_witness(pw, value[1])

    def get_witness(self, values):
        return (self.c0.get_witness(values), self.c1.get_witness(values))

    def is_valid(self, builder) -> Target:
        return builder.mul(self.c0.is_valid(builder), self.c1.is_valid(builder))

    def take_mod(self, builder) -> "Fq2Target":
        return Fq2Target(self.c0.take_mod(builder), self.c1.take_mod(builder))

    def connect(self, builder, other: "Fq2Target"):
        self.c0.connect(builder, other.c0)
        self.c1.connect(builder, other.c1)

    def connect_conditional(self, builder, other: "Fq2Target", flag: Target):
        self.c0.connect_conditional(builder, other.c0, flag)
        self.c1.connect_conditional(builder, other.c1, flag)

    def select(self, builder, other: "Fq2Target", flag: Target) -> "Fq2Target":
        return Fq2Target(
            self.c0.select(builder, other.c0, flag),
            self.c1.select(builder, other.c1, flag),
        )

    # -- arithmetic ------------------------------------------------------

    def add(self, builder, other: "Fq2Target") -> "Fq2Target":
        return Fq2Target(
            self.c0.add(builder, other.c0), self.c1.add(builder, other.c1)
        )

    def neg(self, builder) -> "Fq2Target":
        return Fq2Target(self.c0.neg(builder), self.c1.neg(builder))

    def sub(self, builder, other: "Fq2Target") -> "Fq2Target":
        return Fq2Target(
            self.c0.sub(builder, other.c0), self.c1.sub(builder, other.c1)
        )

    def mul(self, builder, other: "Fq2Target") -> "Fq2Target":
        # (a0 b0 - a1 b1) + (a0 b1 + a1 b0) u  (schoolbook, fq2.rs)
        a0b0 = self.c0.mul(builder, other.c0)
        a1b1 = self.c1.mul(builder, other.c1)
        a0b1 = self.c0.mul(builder, other.c1)
        a1b0 = self.c1.mul(builder, other.c0)
        return Fq2Target(
            a0b0.sub(builder, a1b1), a0b1.add(builder, a1b0)
        )

    def mul_constant_u32(self, builder, c: int) -> "Fq2Target":
        return Fq2Target(
            self.c0.mul_constant_u32(builder, c),
            self.c1.mul_constant_u32(builder, c),
        )

    def is_zero(self, builder) -> Target:
        return builder.mul(self.c0.is_zero(builder), self.c1.is_zero(builder))

    def is_equal(self, builder, other: "Fq2Target") -> Target:
        return builder.mul(
            self.c0.is_equal(builder, other.c0), self.c1.is_equal(builder, other.c1)
        )

    def sgn(self, builder) -> Target:
        """RFC-9380 sgn0 over Fq2 (fq2.rs:182): sgn(c0) or (c0==0 and sgn(c1))."""
        s0 = self.c0.sgn(builder)
        z0 = self.c0.is_zero(builder)
        s1 = self.c1.sgn(builder)
        # s0 + z0*s1 (exclusive: z0=1 forces s0=0)
        return builder.mul_add(z0, s1, s0)

    def inv(self, builder) -> "Fq2Target":
        """Hint inverse with self * out = 1 check (fq2.rs:191)."""
        out = Fq2Target.new_checked(builder)

        def run(w, x=self, out=out):
            v = x.get_witness(w)
            inv_v = oracle.fq2_inv(v)
            res = {}
            for i, t in enumerate(out.c0.value.limbs):
                res[t.index] = (inv_v[0] >> (32 * i)) & bu.LIMB_MASK
            for i, t in enumerate(out.c1.value.limbs):
                res[t.index] = (inv_v[1] >> (32 * i)) & bu.LIMB_MASK
            return res

        builder.add_generator(
            Generator(
                [t.index for t in self.to_vec()],
                [t.index for t in out.to_vec()],
                run,
                "fq2_inv",
            )
        )
        prod = self.mul(builder, out).take_mod(builder)
        prod.connect(builder, Fq2Target.one(builder))
        return out

    def sqrt_with_sgn(self, builder, sgn: Target) -> "Fq2Target":
        """Hint sqrt with sqrt^2 = x and sgn(sqrt) = sgn (fq2.rs:209-226)."""
        out = Fq2Target.new_checked(builder)

        def run(w, x=self, out=out, sgn=sgn):
            v = x.get_witness(w)
            r = oracle.fq2_sqrt(v)
            assert r is not None, "sqrt_with_sgn on non-square"
            if oracle.fq2_sgn(r) != bool(w[sgn.index]):
                r = oracle.fq2_neg(r)
            res = {}
            for i, t in enumerate(out.c0.value.limbs):
                res[t.index] = (r[0] >> (32 * i)) & bu.LIMB_MASK
            for i, t in enumerate(out.c1.value.limbs):
                res[t.index] = (r[1] >> (32 * i)) & bu.LIMB_MASK
            return res

        builder.add_generator(
            Generator(
                [t.index for t in self.to_vec()] + [sgn.index],
                [t.index for t in out.to_vec()],
                run,
                "fq2_sqrt",
            )
        )
        sq = out.mul(builder, out).take_mod(builder)
        sq.connect(builder, self.take_mod(builder))
        out_sgn = out.sgn(builder)
        builder.connect(out_sgn, sgn)
        return out

    def is_square(self, builder) -> Target:
        """a square iff norm = c0^2 + c1^2 is a square in Fq (fq2.rs:228)."""
        norm = self.c0.mul(builder, self.c0).add(
            builder, self.c1.mul(builder, self.c1)
        )
        return norm.is_square(builder)
