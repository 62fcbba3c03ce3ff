"""BigUint gadget: multi-limb u32 arithmetic in-circuit.

Copy of `plonky2_bn254_tpu/circuit/biguint.py`: host Python on ints, which
records the same targets and constraints as the original (tests/test_torch_circuit.py
holds the two packages' circuits equal).

Rebuild of the reference crate's src/fields/biguint.rs:49-369 (`BigUintTarget`,
`CircuitBuilderBiguint`): little-endian 32-bit limb targets with
carry-witnessed add/sub/mul, borrow-chain comparison, and nondeterministic
div_rem witnessed by `a = q*b + r` plus `r <= b - 1`.

Range checks are recorded as (target, bits) pairs on the builder and
enforced by the witness-checking backend; in the deferred PLONK stage they
become lookup gates (the plonky2_u32 role).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..field import goldilocks as gl
from .builder import CircuitBuilder, Constraint, Generator, Target

LIMB_BITS = 32
LIMB_MASK = (1 << 32) - 1


def _ensure_range_list(builder: CircuitBuilder):
    if not hasattr(builder, "range_checks"):
        builder.range_checks = []
    return builder.range_checks


def range_check(builder: CircuitBuilder, t: Target, bits: int):
    _ensure_range_list(builder).append((t.index, bits))


@dataclass
class BigUintTarget:
    limbs: List[Target]  # little-endian u32 limbs

    @property
    def num_limbs(self) -> int:
        return len(self.limbs)

    def get_limb(self, i: int) -> Target:
        return self.limbs[i]

    def to_vec(self) -> List[Target]:
        return list(self.limbs)

    def set_witness(self, pw, value: int):
        for i, limb in enumerate(self.limbs):
            pw.set_target(limb, (value >> (32 * i)) & LIMB_MASK)

    def get_witness(self, values) -> int:
        return sum(values[l.index] << (32 * i) for i, l in enumerate(self.limbs))


# -- construction -----------------------------------------------------------


def add_virtual_biguint_target(builder: CircuitBuilder, num_limbs: int) -> BigUintTarget:
    limbs = builder.add_virtual_targets(num_limbs)
    for t in limbs:
        range_check(builder, t, 32)
    return BigUintTarget(limbs)


def constant_biguint(builder: CircuitBuilder, value: int) -> BigUintTarget:
    n = max(1, (value.bit_length() + 31) // 32)
    return BigUintTarget(
        [builder.constant((value >> (32 * i)) & LIMB_MASK) for i in range(n)]
    )


def zero_biguint(builder: CircuitBuilder) -> BigUintTarget:
    return BigUintTarget([builder.zero()])


def connect_biguint(builder: CircuitBuilder, a: BigUintTarget, b: BigUintTarget):
    a2, b2 = pad_biguints(builder, a, b)
    for x, y in zip(a2.limbs, b2.limbs):
        builder.connect(x, y)


def pad_biguints(builder: CircuitBuilder, a: BigUintTarget, b: BigUintTarget):
    n = max(a.num_limbs, b.num_limbs)
    z = builder.zero()
    pa = BigUintTarget(a.limbs + [z] * (n - a.num_limbs))
    pb = BigUintTarget(b.limbs + [z] * (n - b.num_limbs))
    return pa, pb


# -- arithmetic -------------------------------------------------------------


def add_biguint(builder: CircuitBuilder, a: BigUintTarget, b: BigUintTarget) -> BigUintTarget:
    """Limbwise add with boolean carries; result has one extra limb."""
    a, b = pad_biguints(builder, a, b)
    n = a.num_limbs
    out = add_virtual_biguint_target(builder, n + 1)
    carries = builder.add_virtual_targets(n)
    for c in carries:
        builder.assert_bool(c)

    base = 1 << 32
    for i in range(n):
        # a_i + b_i + carry_in = out_i + base * carry_i
        mono = [
            (1, [a.limbs[i].index]),
            (1, [b.limbs[i].index]),
            (gl.P - 1, [out.limbs[i].index]),
            (gl.P - base, [carries[i].index]),
        ]
        if i > 0:
            mono.append((1, [carries[i - 1].index]))
        builder.constraints.append(Constraint(mono, tag="biguint_add"))
    builder.connect(out.limbs[n], carries[n - 1])

    def run(w, a=a, b=b, out=out, carries=carries, n=n):
        res = {}
        carry = 0
        for i in range(n):
            t = w[a.limbs[i].index] + w[b.limbs[i].index] + carry
            res[out.limbs[i].index] = t & LIMB_MASK
            carry = t >> 32
            res[carries[i].index] = carry
        res[out.limbs[n].index] = carry
        return res

    builder.add_generator(
        Generator(
            [t.index for t in a.limbs + b.limbs],
            [t.index for t in out.limbs + carries],
            run,
            "biguint_add",
        )
    )
    return out


def sub_biguint(builder: CircuitBuilder, a: BigUintTarget, b: BigUintTarget) -> BigUintTarget:
    """a - b with borrow chain; requires a >= b (final borrow forced 0)."""
    a, b = pad_biguints(builder, a, b)
    n = a.num_limbs
    out = add_virtual_biguint_target(builder, n)
    borrows = builder.add_virtual_targets(n)
    for t in borrows:
        builder.assert_bool(t)
    base = 1 << 32
    for i in range(n):
        # a_i - b_i - borrow_in + base*borrow_i = out_i
        mono = [
            (1, [a.limbs[i].index]),
            (gl.P - 1, [b.limbs[i].index]),
            (base, [borrows[i].index]),
            (gl.P - 1, [out.limbs[i].index]),
        ]
        if i > 0:
            mono.append((gl.P - 1, [borrows[i - 1].index]))
        builder.constraints.append(Constraint(mono, tag="biguint_sub"))
    builder.assert_zero(borrows[n - 1])

    def run(w, a=a, b=b, out=out, borrows=borrows, n=n):
        res = {}
        borrow = 0
        for i in range(n):
            t = w[a.limbs[i].index] - w[b.limbs[i].index] - borrow
            borrow = 1 if t < 0 else 0
            res[out.limbs[i].index] = t + borrow * base
            res[borrows[i].index] = borrow
        return res

    builder.add_generator(
        Generator(
            [t.index for t in a.limbs + b.limbs],
            [t.index for t in out.limbs + borrows],
            run,
            "biguint_sub",
        )
    )
    return out


def mul_biguint(builder: CircuitBuilder, a: BigUintTarget, b: BigUintTarget) -> BigUintTarget:
    """Schoolbook product with per-column carry witnesses.

    Column k: sum_{i+j=k} a_i b_j + carry_{k-1} = out_k + 2^32 * carry_k,
    carries range-checked to 37 bits (<= (k+1) * (2^32-1)^2 / 2^32 bound).
    """
    na, nb = a.num_limbs, b.num_limbs
    n_out = na + nb
    out = add_virtual_biguint_target(builder, n_out)
    carries = builder.add_virtual_targets(n_out)
    for t in carries:
        range_check(builder, t, 40)
    base = 1 << 32
    for k in range(n_out):
        mono = []
        for i in range(na):
            j = k - i
            if 0 <= j < nb:
                mono.append((1, [a.limbs[i].index, b.limbs[j].index]))
        if k > 0:
            mono.append((1, [carries[k - 1].index]))
        mono.append((gl.P - 1, [out.limbs[k].index]))
        mono.append((gl.P - base, [carries[k].index]))
        builder.constraints.append(Constraint(mono, tag="biguint_mul"))
    builder.assert_zero(carries[n_out - 1])

    def run(w, a=a, b=b, out=out, carries=carries):
        res = {}
        carry = 0
        for k in range(n_out):
            col = carry
            for i in range(na):
                j = k - i
                if 0 <= j < nb:
                    col += w[a.limbs[i].index] * w[b.limbs[j].index]
            res[out.limbs[k].index] = col & LIMB_MASK
            carry = col >> 32
            res[carries[k].index] = carry
        return res

    builder.add_generator(
        Generator(
            [t.index for t in a.limbs + b.limbs],
            [t.index for t in out.limbs + carries],
            run,
            "biguint_mul",
        )
    )
    return out


def mul_biguint_by_bool(builder: CircuitBuilder, a: BigUintTarget, flag: Target) -> BigUintTarget:
    return BigUintTarget([builder.mul(l, flag) for l in a.limbs])


def mul_add_biguint(builder, a, b, c) -> BigUintTarget:
    return add_biguint(builder, mul_biguint(builder, a, b), c)


# -- comparison -------------------------------------------------------------


def _is_zero(builder: CircuitBuilder, t: Target) -> Target:
    """Boolean 1 iff t == 0, witnessed inverse (standard gadget)."""
    z = builder.add_virtual_target()
    inv = builder.add_virtual_target()
    builder.assert_bool(z)
    # t * inv = 1 - z ; z * t = 0
    builder.constraints.append(
        Constraint(
            [(1, [t.index, inv.index]), (1, [z.index]), (gl.P - 1, [])],
            tag="is_zero_inv",
        )
    )
    builder.constraints.append(
        Constraint([(1, [z.index, t.index])], tag="is_zero_prod")
    )

    def run(w, t=t, z=z, inv=inv):
        v = w[t.index]
        return {
            z.index: 1 if v == 0 else 0,
            inv.index: 0 if v == 0 else gl.h_inv(v),
        }

    builder.add_generator(Generator([t.index], [z.index, inv.index], run, "is_zero"))
    return z


def cmp_biguint(builder: CircuitBuilder, a: BigUintTarget, b: BigUintTarget) -> Target:
    """Boolean target: a <= b (reference cmp_biguint semantics)."""
    a, b = pad_biguints(builder, a, b)
    n = a.num_limbs
    le = builder.one()  # equality so far => a <= b
    for i in range(n):  # least significant first; final le dominated by MSBs
        ai, bi = a.limbs[i], b.limbs[i]
        d = builder.sub(bi, ai)
        eq = _is_zero(builder, d)
        # lt_i: a_i < b_i, witnessed by u32 diff: lt ? b-a-1 : a-b  in [0,2^32)
        lt = builder.add_virtual_target()
        builder.assert_bool(lt)
        diff = builder.add_virtual_target()
        range_check(builder, diff, 32)
        # lt*(b - a - 1 - diff) + (1-lt)*(a - b - diff) = 0
        # expanded: 2*lt*b - 2*lt*a - lt + a - b - diff = 0
        builder.constraints.append(
            Constraint(
                [
                    (2, [lt.index, bi.index]),
                    (gl.P - 2, [lt.index, ai.index]),
                    (gl.P - 1, [lt.index]),
                    (1, [ai.index]),
                    (gl.P - 1, [bi.index]),
                    (gl.P - 1, [diff.index]),
                ],
                tag="u32_lt",
            )
        )

        def run(w, ai=ai, bi=bi, lt=lt, diff=diff):
            av, bv = w[ai.index], w[bi.index]
            if av < bv:
                return {lt.index: 1, diff.index: bv - av - 1}
            return {lt.index: 0, diff.index: av - bv}

        builder.add_generator(
            Generator([ai.index, bi.index], [lt.index, diff.index], run, "u32_lt")
        )
        # le = lt | (eq & le_prev)  = lt + eq*le_prev  (exclusive cases)
        le = builder.mul_add(eq, le, lt)
    builder.assert_bool(le)
    return le


def div_rem_biguint(builder: CircuitBuilder, a: BigUintTarget, b_value: int):
    """a = q * b + r with r <= b - 1, b a constant; returns (q, r).

    Mirrors BigUintDivRemGenerator (biguint.rs nondeterministic div_rem).
    """
    n = a.num_limbs
    b = constant_biguint(builder, b_value)
    q = add_virtual_biguint_target(builder, n)
    r = add_virtual_biguint_target(builder, b.num_limbs)

    def run(w, a=a, q=q, r=r, b_value=b_value):
        av = a.get_witness(w)
        qv, rv = divmod(av, b_value)
        res = {}
        for i, t in enumerate(q.limbs):
            res[t.index] = (qv >> (32 * i)) & LIMB_MASK
        for i, t in enumerate(r.limbs):
            res[t.index] = (rv >> (32 * i)) & LIMB_MASK
        return res

    builder.add_generator(
        Generator(
            [t.index for t in a.limbs],
            [t.index for t in q.limbs + r.limbs],
            run,
            "biguint_div_rem",
        )
    )
    qb_r = mul_add_biguint(builder, q, b, r)
    connect_biguint(builder, qb_r, a)
    b_minus_1 = constant_biguint(builder, b_value - 1)
    le = cmp_biguint(builder, r, b_minus_1)
    builder.connect(le, builder.one())
    return q, r
