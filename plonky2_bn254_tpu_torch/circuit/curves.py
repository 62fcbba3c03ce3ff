"""G1Target / G2Target: affine point gadgets.

Copy of `plonky2_bn254_tpu/circuit/curves.py`: host Python on ints, which
records the same targets and constraints as the original (tests/test_torch_circuit.py
holds the two packages' circuits equal).

Rebuild of the reference crate's src/curves/g1.rs:17-175 and g2.rs:15-157:
on-curve checks (y^2 = x^3 + b), unified add/double with the is_equal
branch select and connect_conditional anti-infinity guard, neg, and
recover_from_x.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..bn254 import oracle, params
from .builder import Target
from .fq import FqTarget
from .fq2 import Fq2Target


@dataclass
class G1Target:
    x: FqTarget
    y: FqTarget

    @staticmethod
    def b() -> int:
        return params.B_G1

    @staticmethod
    def g(x: int) -> int:
        """RHS of the curve equation: x^3 + b (g1.rs:35)."""
        return (x * x * x + params.B_G1) % params.P

    @staticmethod
    def g_circuit(builder, x: FqTarget) -> FqTarget:
        x2 = x.mul(builder, x)
        x3 = x2.mul(builder, x)
        return x3.add(builder, FqTarget.constant(builder, params.B_G1))

    @staticmethod
    def new_unchecked(builder) -> "G1Target":
        return G1Target(FqTarget.new_unchecked(builder), FqTarget.new_unchecked(builder))

    @staticmethod
    def new_checked(builder) -> "G1Target":
        p = G1Target(FqTarget.new_checked(builder), FqTarget.new_checked(builder))
        valid = p.is_valid(builder)
        builder.connect(valid, builder.one())
        return p

    @staticmethod
    def from_value(x: FqTarget, y: FqTarget) -> "G1Target":
        return G1Target(x, y)

    @staticmethod
    def constant(builder, value) -> "G1Target":
        return G1Target(
            FqTarget.constant(builder, value[0]), FqTarget.constant(builder, value[1])
        )

    def is_valid(self, builder) -> Target:
        y2 = self.y.mul(builder, self.y)
        rhs = G1Target.g_circuit(builder, self.x)
        return y2.is_equal(builder, rhs)

    def connect(self, builder, other: "G1Target"):
        self.x.connect(builder, other.x)
        self.y.connect(builder, other.y)

    def neg(self, builder) -> "G1Target":
        return G1Target(self.x, self.y.neg(builder).take_mod(builder))

    def to_vec(self):
        return self.x.to_vec() + self.y.to_vec()

    @staticmethod
    def from_slice(targets) -> "G1Target":
        h = len(targets) // 2
        return G1Target(FqTarget.from_slice(targets[:h]), FqTarget.from_slice(targets[h:]))

    def set_witness(self, pw, value):
        self.x.set_witness(pw, value[0])
        self.y.set_witness(pw, value[1])

    def get_witness(self, values):
        return (self.x.get_witness(values), self.y.get_witness(values))

    def add(self, builder, other: "G1Target") -> "G1Target":
        """Unified add/double (g1.rs:121-149): lambda branch-selected on
        x-equality; x equal forces y equal (anti-infinity guard)."""
        is_eq = self.x.is_equal(builder, other.x)
        # other != -self is enforced: if x equal, y must equal
        self.y.connect_conditional(builder, other.y, is_eq)

        # chord: (y2 - y1) / (x2 - x1); tangent: 3 x^2 / (2 y)
        dx = other.x.sub(builder, self.x).take_mod(builder)
        dy = other.y.sub(builder, self.y).take_mod(builder)
        chord = dy.mul(builder, dx.inv(builder))
        x_sq = self.x.mul(builder, self.x)
        three_x_sq = x_sq.mul_constant_u32(builder, 3)
        two_y = self.y.mul_constant_u32(builder, 2).take_mod(builder)
        tangent = three_x_sq.mul(builder, two_y.inv(builder))
        lam = tangent.take_mod(builder).select(
            builder, chord.take_mod(builder), is_eq
        )

        lam_sq = lam.mul(builder, lam)
        x3 = lam_sq.sub(builder, self.x).sub(builder, other.x).take_mod(builder)
        y3 = (
            lam.mul(builder, self.x.sub(builder, x3))
            .sub(builder, self.y)
            .take_mod(builder)
        )
        return G1Target(x3, y3)

    def is_recoverable_from_x(self, builder) -> Target:
        """x on-curve check via is_square of g(x) (g1.rs:77) — STARK path."""
        rhs = G1Target.g_circuit(builder, self.x).take_mod(builder)
        return rhs.is_square(builder)

    @staticmethod
    def recover_from_x(builder, x: FqTarget) -> "G1Target":
        """y from x with even-sgn convention (g1.rs:90)."""
        rhs = G1Target.g_circuit(builder, x).take_mod(builder)
        y = rhs.sqrt_with_sgn(builder, builder.zero())
        return G1Target(x.take_mod(builder), y)


@dataclass
class G2Target:
    x: Fq2Target
    y: Fq2Target

    @staticmethod
    def b():
        return (params.B_G2_C0, params.B_G2_C1)

    @staticmethod
    def b_target(builder) -> Fq2Target:
        return Fq2Target.constant(builder, G2Target.b())

    @staticmethod
    def g(x):
        """x^3 + b over Fq2 (g2.rs:42)."""
        return oracle.fq2_add(
            oracle.fq2_mul(oracle.fq2_mul(x, x), x), G2Target.b()
        )

    @staticmethod
    def g_circuit(builder, x: Fq2Target) -> Fq2Target:
        x2 = x.mul(builder, x)
        x3 = x2.mul(builder, x)
        return x3.add(builder, G2Target.b_target(builder))

    @staticmethod
    def new_unchecked(builder) -> "G2Target":
        return G2Target(Fq2Target.new_unchecked(builder), Fq2Target.new_unchecked(builder))

    @staticmethod
    def new_checked(builder) -> "G2Target":
        p = G2Target(Fq2Target.new_checked(builder), Fq2Target.new_checked(builder))
        valid = p.is_valid(builder)
        builder.connect(valid, builder.one())
        return p

    @staticmethod
    def from_value(x: Fq2Target, y: Fq2Target) -> "G2Target":
        return G2Target(x, y)

    @staticmethod
    def constant(builder, value) -> "G2Target":
        return G2Target(
            Fq2Target.constant(builder, value[0]), Fq2Target.constant(builder, value[1])
        )

    def is_valid(self, builder) -> Target:
        y2 = self.y.mul(builder, self.y)
        rhs = G2Target.g_circuit(builder, self.x)
        return y2.is_equal(builder, rhs)

    def connect(self, builder, other: "G2Target"):
        self.x.connect(builder, other.x)
        self.y.connect(builder, other.y)

    def neg(self, builder) -> "G2Target":
        return G2Target(self.x, self.y.neg(builder).take_mod(builder))

    def to_vec(self):
        return self.x.to_vec() + self.y.to_vec()

    @staticmethod
    def from_slice(targets) -> "G2Target":
        h = len(targets) // 2
        return G2Target(Fq2Target.from_slice(targets[:h]), Fq2Target.from_slice(targets[h:]))

    def set_witness(self, pw, value):
        self.x.set_witness(pw, value[0])
        self.y.set_witness(pw, value[1])

    def get_witness(self, values):
        return (self.x.get_witness(values), self.y.get_witness(values))

    def add(self, builder, other: "G2Target") -> "G2Target":
        """Unified add/double over Fq2 (g2.rs:103-131)."""
        is_eq = self.x.is_equal(builder, other.x)
        self.y.connect_conditional(builder, other.y, is_eq)

        dx = other.x.sub(builder, self.x).take_mod(builder)
        dy = other.y.sub(builder, self.y).take_mod(builder)
        chord = dy.mul(builder, dx.inv(builder))
        x_sq = self.x.mul(builder, self.x)
        three_x_sq = x_sq.mul_constant_u32(builder, 3)
        two_y = self.y.mul_constant_u32(builder, 2).take_mod(builder)
        tangent = three_x_sq.mul(builder, two_y.inv(builder))
        lam = tangent.take_mod(builder).select(
            builder, chord.take_mod(builder), is_eq
        )

        lam_sq = lam.mul(builder, lam)
        x3 = lam_sq.sub(builder, self.x).sub(builder, other.x).take_mod(builder)
        y3 = (
            lam.mul(builder, self.x.sub(builder, x3))
            .sub(builder, self.y)
            .take_mod(builder)
        )
        return G2Target(x3, y3)
