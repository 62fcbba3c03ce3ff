"""The outer proof of a circuit: its universal-gate STARK, checked plainly.

A frozen copy of the program's outer layout and gate (every row: four
quadratic terms, ten linear wire slots, R range limbs and a constant; the
Poseidon region's rounds), its lookups (wire slots bound to the witness
table by a keyed LogUp, range limbs to the range table) and its public
statement (a cross-table lookup of the public wires' keys and values), as
the program stated them when the benchmark was written, evaluated at one
point of GF(p^2).

The constant columns (which wire each slot reads, the gate coefficients,
the witness keys, the public filter, the range table and the Poseidon
region's constants) are the circuit: they come from the program's compiled
circuit in value form, and this module evaluates them at the opening point
itself (barycentric, on the trace domain), so the check does not rest on the
program's verifier key.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import field as F
from .stark import Ctl, KeyedLookup, Lookup, Machine

W12 = F.WIDTH


@dataclass(frozen=True)
class OuterLayout:
    S: int
    Q: int
    R: int
    NP: int

    @property
    def r(self):
        return self.S

    @property
    def wit_val(self):
        return self.S + self.R

    @property
    def wfreq(self):
        return self.S + self.R + 1

    @property
    def rfreq(self):
        return self.S + self.R + 2

    @property
    def ps(self):
        return self.S + self.R + 3

    @property
    def px3(self):
        return self.ps + W12

    @property
    def px7(self):
        return self.px3 + W12

    @property
    def idx(self):
        return self.S + self.R + 3 + (3 * W12 if self.NP else 0)

    @property
    def qcol(self):
        return self.idx + self.S

    @property
    def ccol(self):
        return self.qcol + self.Q

    @property
    def ecol(self):
        return self.ccol + self.S

    @property
    def c0col(self):
        return self.ecol + self.R

    @property
    def wit_key(self):
        return self.c0col + 1

    @property
    def is_pub(self):
        return self.wit_key + 1

    @property
    def range_table(self):
        return self.is_pub + 1

    @property
    def prc(self):
        return self.range_table + 1

    @property
    def pidx(self):
        return self.prc + W12

    @property
    def pactive(self):
        return self.pidx + W12

    @property
    def pfull(self):
        return self.pactive + 1

    @property
    def pbind(self):
        return self.pfull + 1

    @property
    def width(self):
        return self.range_table + 1 + ((2 * W12 + 3) if self.NP else 0)


def _eval_fn(lay: OuterLayout):
    mds = F.mds()

    def eval_outer_gate(consumer, ring, local, next_):
        acc = local[lay.c0col]
        for k in range(lay.Q):
            acc = acc + local[lay.qcol + k] * (local[2 * k] * local[2 * k + 1])
        for j in range(lay.S):
            acc = acc + local[lay.ccol + j] * local[j]
        for j in range(lay.R):
            acc = acc + local[lay.ecol + j] * local[lay.r + j]
        consumer.constraint(acc)
        if not lay.NP:
            return
        pfull, pactive = local[lay.pfull], local[lay.pactive]
        sels = []
        for e in range(W12):
            u = local[lay.ps + e] + local[lay.prc + e]
            x3, x7 = local[lay.px3 + e], local[lay.px7 + e]
            consumer.constraint(x3 - u * u * u)
            consumer.constraint(x7 - x3 * x3 * u)
            sels.append(x7 if e == 0 else pfull * x7 + u - pfull * u)
        for e in range(W12):
            acc_e = sels[0].scalar_mul(mds[e][0])
            for j in range(1, W12):
                acc_e = acc_e + sels[j].scalar_mul(mds[e][j])
            consumer.constraint(pactive * (next_[lay.ps + e] - acc_e))

    return eval_outer_gate


def outer_machine(lay: OuterLayout, pub_wires: list) -> Machine:
    pairs = [(lay.idx + j, j) for j in range(lay.S)]
    filters = None
    if lay.NP:
        pairs += [(lay.pidx + e, lay.ps + e) for e in range(W12)]
        filters = tuple([None] * lay.S + [lay.pbind] * W12)
    wires = list(pub_wires)
    return Machine(
        name="outer", width=lay.width, eval_fn=_eval_fn(lay),
        lookups=[KeyedLookup(pairs, lay.wit_key, lay.wit_val, lay.wfreq, filters),
                 Lookup([lay.r + j for j in range(lay.R)], lay.range_table, lay.rfreq)],
        ctls=[Ctl([("single", lay.wit_key), ("single", lay.wit_val)], lay.is_pub)],
        ctl_values=lambda publics: {0: [[int(i), int(v) % F.P] for i, v in
                                        zip(wires, publics)]})


# ---------------------------------------------------------------------------
# the constant columns at a point, from their values on the trace domain
# ---------------------------------------------------------------------------


def _np_batch_inv(x: np.ndarray) -> np.ndarray:
    """Elementwise inverses of nonzero field elements: a product tree."""
    levels = [x]
    while levels[-1].size > 1:
        cur = levels[-1]
        if cur.size % 2:
            cur = np.concatenate([cur, np.ones(1, dtype=np.uint64)])
        levels.append(F.np_mul(cur[0::2], cur[1::2]))
    inv = np.array([F.inv(int(levels[-1][0]))], dtype=np.uint64)
    for lower in reversed(levels[:-1]):
        n = lower.size
        pad = np.concatenate([lower, np.ones(1, dtype=np.uint64)]) if n % 2 else lower
        out = np.empty(pad.size, dtype=np.uint64)
        out[0::2] = F.np_mul(inv, pad[1::2])
        out[1::2] = F.np_mul(inv, pad[0::2])
        inv = out[:n]
    return inv


def _np_sum(a: np.ndarray) -> int:
    """Sum mod p of canonical field elements, exactly."""
    return (int((a & np.uint64(0xFFFFFFFF)).sum(dtype=np.uint64))
            + (int((a >> np.uint64(32)).sum(dtype=np.uint64)) << 32)) % F.P


def barycentric_weights(n_log: int, z: F.Ext):
    """(w0, w1, scale): p(z) = scale * sum_i v_i * (w0_i + w1_i X) for the
    polynomial of degree < n with values v_i at g^i (Lagrange, barycentric)."""
    n = 1 << n_log
    g = F.root_of_unity(n_log)
    pts = np.empty(n, dtype=np.uint64)
    pts[0] = 1
    step, filled = g, 1
    while filled < n:  # powers by doubling: pts[k:2k] = pts[:k] * g^k
        take = min(filled, n - filled)
        pts[filled:filled + take] = F.np_mul(pts[:take], np.uint64(step))
        filled += take
        step = step * step % F.P
    # 1 / (z - x) = (z0 - x, -z1) / ((z0 - x)^2 - 7 z1^2)
    a = F.np_add(np.uint64(z.c0), np.uint64(F.P) - pts)
    norm = F.np_add(F.np_mul(a, a), np.uint64((F.P - F.EXT_W * z.c1 * z.c1 % F.P) % F.P))
    ninv_pts = F.np_mul(_np_batch_inv(norm), pts)
    w0 = F.np_mul(a, ninv_pts)
    w1 = F.np_mul(ninv_pts, np.uint64((F.P - z.c1) % F.P))
    scale = (z.exp(n) - F.Ext(1)).scalar_mul(F.inv(n))
    return w0, w1, scale


COEFF_BITS = 26  # a combination of up to 64 columns of 32-bit halves stays in 64 bits


def combined_opening(values: np.ndarray, coeffs: list, weights) -> F.Ext:
    """sum_c coeffs[c] * p_c(z) for the columns `values` [k, n] (uint64),
    each coefficient below 2^COEFF_BITS."""
    w0, w1, scale = weights
    if len(coeffs) > 64 or max(coeffs) >> COEFF_BITS:
        raise ValueError("too many columns or too wide a coefficient")
    r = np.asarray(coeffs, dtype=np.uint64)[None, :]
    vals = F.canonical(values)
    lo = (r @ (vals & np.uint64(0xFFFFFFFF)))[0]
    hi = (r @ (vals >> np.uint64(32)))[0]
    low = (hi << np.uint64(32)) + lo
    combo = F.reduce128((hi >> np.uint64(32)) + (low < lo).astype(np.uint64), low)
    return scale * F.Ext(_np_sum(F.np_mul(combo, w0)), _np_sum(F.np_mul(combo, w1)))


def constant_column_check(lay: OuterLayout, const_values: np.ndarray, n_log: int,
                          rng: np.random.Generator):
    """A `verify` opening check: a random combination of the constant
    columns, evaluated at zeta and zeta * g from `const_values` [k, n]
    (the columns lay.idx..width in value form), equals the same combination
    of the proof's trace openings."""
    cols = list(range(lay.idx, lay.width))
    if const_values.shape != (len(cols), 1 << n_log):
        raise ValueError("constant columns do not match the layout")
    coeffs = [int(c) for c in rng.integers(1, 1 << COEFF_BITS, len(cols))]

    def check(zeta, zeta_g, trace_zeta, trace_zeta_g):
        for point, opened in ((zeta, trace_zeta), (zeta_g, trace_zeta_g)):
            want = combined_opening(const_values, coeffs, barycentric_weights(n_log, point))
            got = F.Ext(0)
            for col, c in zip(cols, coeffs):
                got = got + opened[col].scalar_mul(c)
            if got != want:
                return "the constant columns' openings differ from the circuit's"
        return None

    return check
