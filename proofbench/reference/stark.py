"""What the batch STARK machines share, at one point.

A frozen copy of the program's machine building blocks as they stood when
the benchmark was written (column layouts, lookups, cross-table lookups,
the modular-arithmetic and round-flag constraints), cut down to what a
verifier evaluates: every value is a scalar of GF(p^2) at the opening
point, so no tensor path is kept.  Each machine is a module of its own in
`machines/`, found by name.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Tuple

from . import bn254

N_LIMBS, LIMB_BITS, N_BITS = 16, 16, 256
PERIOD = 2 * N_BITS  # 512 rows an operation
AUX_COEFF_ABS_MAX = 1 << 29
MOD_LIMBS = [(bn254.P >> (16 * i)) & 0xFFFF for i in range(N_LIMBS)]


def int_to_limbs(x: int, n: int = N_LIMBS) -> list:
    if not 0 <= x < 1 << (LIMB_BITS * n):
        raise ValueError("value does not fit the limbs")
    return [(x >> (LIMB_BITS * i)) & 0xFFFF for i in range(n)]


class Layout:
    """Named column ranges of a trace row, nested."""

    def __init__(self, spec):
        self.spec, self.offsets, self.sizes, off = spec, {}, {}, 0
        for name, size in spec:
            self.offsets[name], self.sizes[name] = off, size
            off += size.width if isinstance(size, Layout) else size
        self.width = off

    def range(self, *path) -> range:
        lay, off = self, 0
        for name in path:
            off += lay.offsets[name]
            sub = lay.sizes[name]
            if not isinstance(sub, Layout):
                return range(off, off + sub)
            lay = sub
        return range(off, off + lay.width)

    def col(self, *path) -> int:
        return self.range(*path).start

    def view(self, row):
        out = {}
        for name, size in self.spec:
            off = self.offsets[name]
            if isinstance(size, Layout):
                out[name] = size.view(row[off:off + size.width])
            elif size == 1:
                out[name] = row[off]
            else:
                out[name] = list(row[off:off + size])
        return out


ROUND_FLAGS = Layout([("is_first_round", 1), ("is_last_round", 1), ("counter", 1),
                      ("inv_counter", 1), ("inv_counter_prime", 1)])
MODULUS_ZERO_AUX = Layout([("is_quot_positive", 1), ("quot_abs", 17), ("aux_lo", 31),
                           ("aux_hi", 31)])
IS_MODULUS_ZERO_AUX = Layout([("inv", 16), ("modulus_zero_aux", MODULUS_ZERO_AUX)])


@dataclass(frozen=True)
class Lookup:
    columns: List[int]
    table_col: int
    freq_col: int


@dataclass(frozen=True)
class KeyedLookup:
    """LogUp of (key, value) pairs, combined as key + beta * value, against
    the table's (key, value) rows; a pair with a filter column takes part
    only where its filter is 1."""

    pairs: List[Tuple[int, int]]
    table_key_col: int
    table_val_col: int
    freq_col: int
    filters: Tuple = None


@dataclass(frozen=True)
class Ctl:
    """A looked table bound to the statement: each entry ("single", col) or
    ("le_bits", cols) of a filtered row against one row of values."""

    columns: List[Tuple]
    filter_col: int

    def eval_row(self, row):
        out = []
        for kind, spec in self.columns:
            if kind == "single":
                out.append(row[spec])
            else:
                acc = row[spec[0]]
                for j, col in enumerate(spec[1:], start=1):
                    acc = acc + row[col].scalar_mul(1 << j)
                out.append(acc)
        return out


@dataclass(frozen=True)
class Machine:
    name: str
    width: int
    eval_fn: Callable
    lookups: List[Lookup]
    ctls: List[Ctl]
    ctl_values: Callable  # operations' inputs -> {ctl index: rows of ints}


# ---------------------------------------------------------------------------
# constraint helpers (scalar values)
# ---------------------------------------------------------------------------


class Consumer:
    """Alpha-combines constraints: every row, all but the last, first, last."""

    def __init__(self, alphas, z_last, l_first, l_last):
        self.alphas, self.z_last, self.l_first, self.l_last = alphas, z_last, l_first, l_last
        self.accs = [a.scalar_mul(0) for a in alphas]

    def constraint(self, c):
        self.accs = [acc * alpha + c for acc, alpha in zip(self.accs, self.alphas)]

    def constraint_transition(self, c):
        self.constraint(c * self.z_last)

    def constraint_first_row(self, c):
        self.constraint(c * self.l_first)

    def constraint_last_row(self, c):
        self.constraint(c * self.l_last)


def eval_eq(consumer, filt, a, b):
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise ValueError("eval_eq: lengths differ")
        for x, y in zip(a, b):
            consumer.constraint(filt * (x - y))
    else:
        consumer.constraint(filt * (a - b))


def pol_add(a, b):
    n = max(len(a), len(b))
    return [a[i] + b[i] if i < len(a) and i < len(b) else (a[i] if i < len(a) else b[i])
            for i in range(n)]


def pol_sub(a, b):
    return [a[i] - b[i] if i < len(b) else a[i] for i in range(len(a))]


def pol_mul_wide(a, b):
    out = [None] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            t = ai * bj
            out[i + j] = t if out[i + j] is None else out[i + j] + t
    return out


def pol_mul_scalar(a, c: int):
    return [x.scalar_mul(c) for x in a]


def pol_adjoin_root(a, root):
    """(x - root) * a(x), same length (a's top coefficient is 0)."""
    return [(root * a[0]).neg()] + [a[i - 1] - root * a[i] for i in range(1, len(a))]


def eval_modulus_zero(consumer, ring, filt, modulus, input_poly, aux):
    """value(input_poly) = 0 mod p, witnessed by a signed quotient and the
    exact division of the difference by (x - 2^16)."""
    iqp, quot_abs = aux["is_quot_positive"], aux["quot_abs"]
    one = ring.one()
    consumer.constraint(filt * (iqp * iqp - iqp))
    sign = iqp + iqp - one
    constr = pol_mul_wide([sign * q for q in quot_abs], modulus)
    base, offset = ring.const(1 << LIMB_BITS), ring.const(AUX_COEFF_ABS_MAX)
    aux_poly = [aux["aux_lo"][i] - offset + base * aux["aux_hi"][i]
                for i in range(2 * N_LIMBS - 1)] + [ring.zero()]
    constr = pol_sub(pol_add(constr, pol_adjoin_root(aux_poly, base)), input_poly)
    for c in constr:
        consumer.constraint(filt * c)


def eval_is_modulus_zero(consumer, ring, filt, modulus, input_limbs, is_zero, aux):
    diff = pol_mul_wide(input_limbs, aux["inv"])
    diff[0] = diff[0] + is_zero - ring.one()
    eval_modulus_zero(consumer, ring, filt, modulus, diff, aux["modulus_zero_aux"])
    for limb in input_limbs:
        consumer.constraint(filt * (is_zero * limb))


def eval_round_flags(consumer, ring, period, filt, flags, next_counter):
    one = ring.one()
    consumer.constraint((one - filt) * flags["is_first_round"])
    consumer.constraint((one - filt) * flags["is_last_round"])
    consumer.constraint(filt * (flags["counter"] * flags["inv_counter"]
                                - (one - flags["is_first_round"])))
    consumer.constraint(filt * flags["counter"] * flags["is_first_round"])
    counter_prime = flags["counter"] - ring.const(period - 1)
    consumer.constraint(filt * (counter_prime * flags["inv_counter_prime"]
                                - (one - flags["is_last_round"])))
    consumer.constraint(filt * counter_prime * flags["is_last_round"])
    consumer.constraint(filt * (one - flags["is_last_round"])
                        * (next_counter - flags["counter"] - one))
    consumer.constraint(filt * flags["is_last_round"] * next_counter)


def eval_fq_mul(consumer, ring, filt, modulus, a, b, c, aux):
    ab = pol_mul_wide(a, b)
    diff = [ab[i] - c[i] if i < N_LIMBS else ab[i] for i in range(2 * N_LIMBS - 1)]
    eval_modulus_zero(consumer, ring, filt, modulus, diff, aux)


def eval_range_counter(consumer, ring, lv, nv):
    diff = nv["range_counter"] - lv["range_counter"]
    consumer.constraint_transition(diff * diff - diff)
    consumer.constraint_last_row(lv["range_counter"] - ring.const((1 << LIMB_BITS) - 1))


def scalar_bits_cols(lay):
    bits0 = lay.range("bits").start
    return [("le_bits", list(range(bits0 + k * LIMB_BITS, bits0 + (k + 1) * LIMB_BITS)))
            for k in range(N_BITS // LIMB_BITS)]


def range_lookup(lay, first: int, last: int):
    return [Lookup(list(range(first, last)), lay.col("range_counter"), lay.col("frequency"))]
