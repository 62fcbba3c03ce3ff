"""Quadratic extension GF(p^2) = GF(p)[X]/(X^2 - 7) of Goldilocks.

Port of `plonky2_bn254_tpu/field/extension.py`.  Tensor flavor: pairs
`(c0, c1)` of int64 residue tensors.  Host flavor: `GLExt` scalars over
python ints (the verifier and the challenger).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import goldilocks as gl

W = 7  # X^2 = 7; 7 is a quadratic non-residue mod the Goldilocks prime.


class Ext(NamedTuple):
    """Tensor extension element: a pair of int64 residue tensors."""

    c0: torch.Tensor
    c1: torch.Tensor

    @staticmethod
    def zero(shape=(), device=None):
        z = torch.zeros(shape, dtype=torch.int64, device=device)
        return Ext(z, z)

    @staticmethod
    def one(shape=(), device=None):
        return Ext(
            torch.ones(shape, dtype=torch.int64, device=device),
            torch.zeros(shape, dtype=torch.int64, device=device),
        )

    def __add__(self, o: "Ext") -> "Ext":
        return Ext(gl.add(self.c0, o.c0), gl.add(self.c1, o.c1))

    def __sub__(self, o: "Ext") -> "Ext":
        return Ext(gl.sub(self.c0, o.c0), gl.sub(self.c1, o.c1))

    def __mul__(self, o: "Ext") -> "Ext":
        # (a0 + a1 X)(b0 + b1 X) = a0 b0 + W a1 b1 + (a0 b1 + a1 b0) X
        a0b0 = gl.mul(self.c0, o.c0)
        a1b1 = gl.mul(self.c1, o.c1)
        a0b1 = gl.mul(self.c0, o.c1)
        a1b0 = gl.mul(self.c1, o.c0)
        return Ext(gl.add(a0b0, gl.mul_const(a1b1, W)), gl.add(a0b1, a1b0))

    def scalar_mul(self, s) -> "Ext":
        return Ext(gl.mul(self.c0, s), gl.mul(self.c1, s))

    def neg(self) -> "Ext":
        return Ext(gl.neg(self.c0), gl.neg(self.c1))

    def square(self) -> "Ext":
        return self * self

    def inv(self) -> "Ext":
        # (a0 + a1 X)^-1 = (a0 - a1 X) / (a0^2 - W a1^2)
        norm = gl.sub(gl.square(self.c0), gl.mul_const(gl.square(self.c1), W))
        ninv = gl.inv(norm)
        return Ext(gl.mul(self.c0, ninv), gl.mul(gl.neg(self.c1), ninv))


# ---------------------------------------------------------------------------
# Host-side scalar extension field (python ints)
# ---------------------------------------------------------------------------


class GLExt:
    """Scalar GF(p^2) element over python ints; immutable."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int = 0):
        self.c0 = c0 % gl.P
        self.c1 = c1 % gl.P

    @staticmethod
    def zero() -> "GLExt":
        return GLExt(0, 0)

    @staticmethod
    def one() -> "GLExt":
        return GLExt(1, 0)

    def __add__(self, o: "GLExt") -> "GLExt":
        return GLExt(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "GLExt") -> "GLExt":
        return GLExt(self.c0 - o.c0, self.c1 - o.c1)

    def __mul__(self, o: "GLExt") -> "GLExt":
        return GLExt(
            self.c0 * o.c0 + W * self.c1 * o.c1, self.c0 * o.c1 + self.c1 * o.c0
        )

    def __neg__(self) -> "GLExt":
        return GLExt(-self.c0, -self.c1)

    def __eq__(self, o) -> bool:
        return isinstance(o, GLExt) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __repr__(self):
        return f"GLExt({self.c0:#x}, {self.c1:#x})"

    def is_zero(self) -> bool:
        return self.c0 == 0 and self.c1 == 0

    def scalar_mul(self, s: int) -> "GLExt":
        return GLExt(self.c0 * s, self.c1 * s)

    def inv(self) -> "GLExt":
        norm = (self.c0 * self.c0 - W * self.c1 * self.c1) % gl.P
        ninv = gl.h_inv(norm)
        return GLExt(self.c0 * ninv, -self.c1 * ninv)

    def exp(self, e: int) -> "GLExt":
        result = GLExt.one()
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def frobenius(self) -> "GLExt":
        return GLExt(self.c0, -self.c1)
