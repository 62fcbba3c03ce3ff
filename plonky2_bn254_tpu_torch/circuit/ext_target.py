"""GF(p^2) extension arithmetic over circuit targets + the target ring.

Copy of `plonky2_bn254_tpu/circuit/ext_target.py`: host Python on ints, which
records the same targets and constraints as the original (tests/test_torch_recursion.py
holds the two packages' circuits equal).

This is the third instantiation of the ring-generic constraint algebra
promised in starks/air.py: the same `eval_*` AIR definitions that drive the
prover (GL tensors) and the native verifier (GLExt scalars) evaluate
here over circuit TARGETS, producing the recursive STARK verifier's
constraints — the rebuild of the reference's `_ext_circuit` constraint
flavor (e.g. the reference crate's src/starks/modular/modulus_zero.rs:163-253)
without duplicating any constraint definition.

Extension: x = c0 + c1*u with u^2 = W = 7 (same tower as field/extension.py
and plonky2's quadratic Goldilocks extension).
"""

from __future__ import annotations

from typing import List

from ..field import goldilocks as gl
from ..field.extension import W
from .builder import CircuitBuilder, Generator, Target


class ExtTarget:
    """Extension value as a pair of base-field targets."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: Target, c1: Target):
        self.c0 = c0
        self.c1 = c1

    def to_vec(self) -> List[Target]:
        return [self.c0, self.c1]


class ExtOps:
    """Builder-bound extension ops (mul is 2 constraints, add/sub 2)."""

    def __init__(self, builder: CircuitBuilder):
        self.b = builder

    def constant(self, c0: int, c1: int = 0) -> ExtTarget:
        return ExtTarget(self.b.constant(c0), self.b.constant(c1))

    def from_base(self, t: Target) -> ExtTarget:
        return ExtTarget(t, self.b.zero())

    def add(self, x: ExtTarget, y: ExtTarget) -> ExtTarget:
        return ExtTarget(self.b.add(x.c0, y.c0), self.b.add(x.c1, y.c1))

    def sub(self, x: ExtTarget, y: ExtTarget) -> ExtTarget:
        return ExtTarget(self.b.sub(x.c0, y.c0), self.b.sub(x.c1, y.c1))

    def neg(self, x: ExtTarget) -> ExtTarget:
        zero = self.b.zero()
        return ExtTarget(self.b.sub(zero, x.c0), self.b.sub(zero, x.c1))

    def mul(self, x: ExtTarget, y: ExtTarget) -> ExtTarget:
        b = self.b
        out0 = b._arith(
            [(1, [x.c0.index, y.c0.index]), (W, [x.c1.index, y.c1.index])],
            "ext_mul0",
            [x.c0, y.c0, x.c1, y.c1],
        )
        out1 = b._arith(
            [(1, [x.c0.index, y.c1.index]), (1, [x.c1.index, y.c0.index])],
            "ext_mul1",
            [x.c0, y.c1, x.c1, y.c0],
        )
        return ExtTarget(out0, out1)

    def mul_add(self, x: ExtTarget, y: ExtTarget, z: ExtTarget) -> ExtTarget:
        """x*y + z fused into two constraints."""
        b = self.b
        out0 = b._arith(
            [
                (1, [x.c0.index, y.c0.index]),
                (W, [x.c1.index, y.c1.index]),
                (1, [z.c0.index]),
            ],
            "ext_muladd0",
            [x.c0, y.c0, x.c1, y.c1, z.c0],
        )
        out1 = b._arith(
            [
                (1, [x.c0.index, y.c1.index]),
                (1, [x.c1.index, y.c0.index]),
                (1, [z.c1.index]),
            ],
            "ext_muladd1",
            [x.c0, y.c1, x.c1, y.c0, z.c1],
        )
        return ExtTarget(out0, out1)

    def scalar_mul(self, x: ExtTarget, k: int) -> ExtTarget:
        return ExtTarget(self.b.mul_const(k, x.c0), self.b.mul_const(k, x.c1))

    def base_mul(self, x: ExtTarget, t: Target) -> ExtTarget:
        return ExtTarget(self.b.mul(x.c0, t), self.b.mul(x.c1, t))

    def inverse(self, x: ExtTarget) -> ExtTarget:
        """Hinted inverse with x * inv = 1 enforced (hence also x != 0,
        matching the native verifier's nonzero checks)."""
        b = self.b
        inv0 = b.add_virtual_target()
        inv1 = b.add_virtual_target()
        inv = ExtTarget(inv0, inv1)

        def run(w, x=x, inv0=inv0, inv1=inv1):
            from ..field.extension import GLExt

            v = GLExt(w[x.c0.index], w[x.c1.index]).inv()
            return {inv0.index: v.c0, inv1.index: v.c1}

        b.add_generator(
            Generator([x.c0.index, x.c1.index], [inv0.index, inv1.index], run,
                      "ext_inv")
        )
        prod = self.mul(x, inv)
        b.connect(prod.c0, b.one())
        b.assert_zero(prod.c1)
        return inv

    def div(self, x: ExtTarget, y: ExtTarget) -> ExtTarget:
        return self.mul(x, self.inverse(y))

    def select(self, flag: Target, x: ExtTarget, y: ExtTarget) -> ExtTarget:
        return ExtTarget(
            self.b.select(flag, x.c0, y.c0), self.b.select(flag, x.c1, y.c1)
        )

    def exp_const(self, x: ExtTarget, e: int) -> ExtTarget:
        result = None
        base = x
        while e > 0:
            if e & 1:
                result = base if result is None else self.mul(result, base)
            e >>= 1
            if e:
                base = self.mul(base, base)
        return result if result is not None else self.constant(1)

    def connect(self, x: ExtTarget, y: ExtTarget):
        self.b.connect(x.c0, y.c0)
        self.b.connect(x.c1, y.c1)


class _RingExt:
    """Operator-syntax wrapper so AIR eval functions run over ExtTargets."""

    __slots__ = ("ops", "v")

    def __init__(self, ops: ExtOps, v: ExtTarget):
        self.ops = ops
        self.v = v

    def __add__(self, o):
        return _RingExt(self.ops, self.ops.add(self.v, o.v))

    def __sub__(self, o):
        return _RingExt(self.ops, self.ops.sub(self.v, o.v))

    def __mul__(self, o):
        return _RingExt(self.ops, self.ops.mul(self.v, o.v))

    def neg(self):
        return _RingExt(self.ops, self.ops.neg(self.v))

    def scalar_mul(self, k: int):
        return _RingExt(self.ops, self.ops.scalar_mul(self.v, k))


class TargetExtRing:
    """Ring factory over ExtTarget values (recursive-verifier flavor)."""

    def __init__(self, builder: CircuitBuilder):
        self.builder = builder
        self.ops = ExtOps(builder)

    def const(self, x) -> _RingExt:
        if isinstance(x, int):
            return _RingExt(self.ops, self.ops.constant(x % gl.P))
        if isinstance(x, Target):
            return _RingExt(self.ops, self.ops.from_base(x))
        if isinstance(x, ExtTarget):
            return _RingExt(self.ops, x)
        raise TypeError(f"cannot lift {type(x)} into TargetExtRing")

    def zero(self):
        return self.const(0)

    def one(self):
        return self.const(1)

    def wrap(self, v) -> _RingExt:
        if isinstance(v, _RingExt):
            return v
        return _RingExt(self.ops, v)


# ---------------------------------------------------------------------------
# bit decomposition / dynamic indexing gadgets (plonky2 split_le /
# random_access equivalents, needed by the recursive FRI verifier)
# ---------------------------------------------------------------------------


def split_le(builder: CircuitBuilder, t: Target, n_bits: int) -> List[Target]:
    """Decompose into n_bits boolean targets, LSB first; constrains
    sum bits_i 2^i = t and each bit boolean.  Like plonky2's split_le the
    decomposition of a field element into 64 bits is unique only up to
    +p; used (as in plonky2's FRI verifier) where either representative
    serves — query-index derivation from a random challenge."""
    bits = builder.add_virtual_targets(n_bits)
    for b in bits:
        builder.assert_bool(b)
    acc = builder.add_linear([(1 << i, b) for i, b in enumerate(bits)])
    builder.connect(acc, t)

    def run(w, t=t, bits=bits):
        v = w[t.index]
        return {b.index: (v >> i) & 1 for i, b in enumerate(bits)}

    builder.add_generator(
        Generator([t.index], [b.index for b in bits], run, "split_le")
    )
    return bits


def le_sum(builder: CircuitBuilder, bits: List[Target]) -> Target:
    """Recombine LSB-first bits into one target."""
    return builder.add_linear([(1 << i, b) for i, b in enumerate(bits)])


def random_access(builder: CircuitBuilder, bits: List[Target], items: List):
    """items[index] where index = sum bits_i 2^i; items are Targets or
    lists of Targets (digests).  Select tree over the bits."""
    is_list = isinstance(items[0], (list, tuple))
    n = len(items)
    assert n == 1 << len(bits), (n, len(bits))
    layer = [list(it) if is_list else [it] for it in items]
    for b in bits:
        nxt = []
        for i in range(0, len(layer), 2):
            nxt.append(
                [
                    builder.select(b, hi, lo)
                    for lo, hi in zip(layer[i], layer[i + 1])
                ]
            )
        layer = nxt
    return layer[0] if is_list else layer[0][0]
