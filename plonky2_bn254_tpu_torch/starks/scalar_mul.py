"""The batched s*x + offset machine, once for G1 (over Fq) and G2 (over Fq2).

Port of the machine shape shared by `plonky2_bn254_tpu/starks/g1_scalar_mul.py`
and `g2_scalar_mul.py`.  512 rows per op, alternating add rows (even counter,
process scalar bit 0) and double rows (odd counter), scalar bits rotated left
after each double row.  `g1_scalar_mul` and `g2_scalar_mul` each describe
their curve as a `Curve` and bind these functions to it.

Trace generation: inversion-free Jacobian chains (a Python loop of batched
limb ops, 256 steps each), one batched inversion per chain to normalise
every point, then ONE batched add-gadget witness pass over the add and
double rows together.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Callable

import torch

from ..utils import timing
from . import bigint, modular, round_flags, rows
from .air import eval_eq
from .layout import Layout, ROUND_FLAGS_LAYOUT
from .limbs import LIMB_BITS, N_BITS, N_LIMBS, h_int_to_limbs
from .table import CtlSpec, Lookup


@dataclass(frozen=True)
class Curve:
    """What the machine takes from a curve.

    A coordinate is a [n, 16] limb tensor over Fq and a [2, n, 16] one over
    Fq2 (c0 and c1 on the leading axis), so a stack of steps puts its steps
    on axis `degree - 1`."""

    degree: int  # 1: coordinates in Fq, 2: in Fq2
    double: Callable  # Jacobian (X, Y, Z) -> (X, Y, Z) doubled
    mixed_add: Callable  # Jacobian (X, Y, Z) + affine (x, y) -> Jacobian
    to_affine: Callable  # Jacobian -> affine, one batched inversion
    generate_add: Callable  # the add gadget's witness: (ax, ay, bx, by) -> (cx, cy, aux)
    eval_add: Callable  # its constraints
    add_aux: Layout  # its aux columns
    aux_cols: Callable  # its aux witness -> column blocks in `add_aux` order
    blocks: Callable  # affine (x, y) -> the point's 16-limb column blocks
    coord: Callable  # [n, 16 degree] input columns of a coordinate -> its tensor
    ints: Callable  # affine point (python ints) -> its coordinates' ints
    mul: Callable  # the oracle's s * x
    add: Callable  # the oracle's x + y

    @property
    def axis(self) -> int:
        return self.degree - 1

    @cached_property
    def layout(self) -> Layout:
        point = Layout([("x", self.degree * N_LIMBS), ("y", self.degree * N_LIMBS)])
        return Layout([("double", point), ("sum", point), ("a", point), ("b", point), ("c", point),
                       ("add_aux", self.add_aux), ("bits", N_BITS),
                       ("round_flags", ROUND_FLAGS_LAYOUT), ("timestamp", 1), ("is_adding", 1),
                       ("is_doubling_not_last", 1), ("filter", 1), ("frequency", 1),
                       ("range_counter", 1)])

    @property
    def range_check_cols(self) -> range:
        """a, b, c and the add gadget's aux: every limb the gadget checks."""
        return range(self.layout.range("a").start, self.layout.range("add_aux").stop)


def _chains(curve: Curve, x, y, ox, oy, s_bits):
    """Jacobian chains + batched affine normalisation.

    Returns affine doubles d_k = 2^k x (k = 0..256), running sums
    p_k = offset + sum_{i<=k, bit_i} d_i (k = 0..255) and p_{k-1}
    (k = 0..255, p_{-1} = offset), each stacked on the curve's steps axis."""
    tt = timing.get(None)
    axis = curve.axis
    one = torch.zeros_like(x)
    one[(0,) * axis + (..., 0)] = 1

    X, Y, Z = x, y, one
    dX, dY, dZ = [X], [Y], [Z]
    with tt.scope("double chain"):
        for _ in range(N_BITS):
            X, Y, Z = curve.double(X, Y, Z)
            dX.append(X)
            dY.append(Y)
            dZ.append(Z)
    with tt.scope("to_affine"):
        d_ax, d_ay = curve.to_affine(torch.stack(dX, axis), torch.stack(dY, axis),
                                     torch.stack(dZ, axis))

    X, Y, Z = ox, oy, one
    pX, pY, pZ = [], [], []
    with tt.scope("add chain"):
        for k in range(N_BITS):
            Xa, Ya, Za = curve.mixed_add(X, Y, Z, d_ax.select(axis, k), d_ay.select(axis, k))
            sel = (s_bits[:, k] == 1)[:, None]
            X = torch.where(sel, Xa, X)
            Y = torch.where(sel, Ya, Y)
            Z = torch.where(sel, Za, Z)
            pX.append(X)
            pY.append(Y)
            pZ.append(Z)
    with tt.scope("to_affine"):
        p_ax, p_ay = curve.to_affine(torch.stack(pX, axis), torch.stack(pY, axis),
                                     torch.stack(pZ, axis))
    # p_{k-1}: the offset (affine already) then p_0 .. p_254
    pp_ax = torch.cat([ox.unsqueeze(axis), p_ax.narrow(axis, 0, N_BITS - 1)], axis)
    pp_ay = torch.cat([oy.unsqueeze(axis), p_ay.narrow(axis, 0, N_BITS - 1)], axis)
    return d_ax, d_ay, p_ax, p_ay, pp_ax, pp_ay


def generate_trace_core(curve: Curve, x, y, ox, oy, s_bits, timestamps, min_rows: int = 0):
    """Coordinates of x and the offset, [n, 256] bits, [n] ts ->
    [num_rows, width] int64 rows (range-check columns zero)."""
    tt = timing.get(None)
    axis, blocks = curve.axis, curve.blocks
    with tt.scope("chains"):
        d_ax, d_ay, p_ax, p_ay, pp_ax, pp_ay = _chains(curve, x, y, ox, oy, s_bits)
    d_lo_ax, d_lo_ay = d_ax.narrow(axis, 0, N_BITS), d_ay.narrow(axis, 0, N_BITS)
    # add rows: p_{k-1} + d_k; double rows: d_k + d_k — one batched pass
    with tt.scope("witness pass"):
        cx, cy, aux = curve.generate_add(
            torch.stack([pp_ax, d_lo_ax], axis), torch.stack([pp_ay, d_lo_ay], axis),
            torch.stack([d_lo_ax, d_lo_ax], axis), torch.stack([d_lo_ay, d_lo_ay], axis),
        )
    with tt.scope("assemble"):
        even_tail, odd_tail = rows.tails(s_bits, timestamps)
        add_rows = (
            blocks(d_lo_ax, d_lo_ay) + blocks(p_ax, p_ay)  # double, sum
            + blocks(pp_ax, pp_ay) + blocks(d_lo_ax, d_lo_ay)  # a, b
            + blocks(cx.select(axis, 0), cy.select(axis, 0))  # c
            + curve.aux_cols(modular.index_tree(aux, 0)) + even_tail
        )
        dbl_rows = (
            # double = d_{k+1}, sum = p_k
            blocks(d_ax.narrow(axis, 1, N_BITS), d_ay.narrow(axis, 1, N_BITS)) + blocks(p_ax, p_ay)
            + blocks(d_lo_ax, d_lo_ay) + blocks(d_lo_ax, d_lo_ay)
            + blocks(cx.select(axis, 1), cy.select(axis, 1))
            + curve.aux_cols(modular.index_tree(aux, 1)) + odd_tail
        )
        return rows.assemble(add_rows, dbl_rows, min_rows)


def add_range_checks(curve: Curve, trace: torch.Tensor) -> torch.Tensor:
    """Fill the range-check counter and frequency columns (in place)."""
    return rows.add_range_checks(trace, curve.range_check_cols,
                                 curve.layout.col("range_counter"), curve.layout.col("frequency"))


def generate_trace(curve: Curve, inputs, min_rows: int = 1 << LIMB_BITS,
                   device="cuda") -> torch.Tensor:
    """inputs: list of (s, x, offset, timestamp), the points affine in
    python ints -> [num_rows, width] int64 trace on `device`: the card
    unless the caller asks for the CPU (`device="cpu"`); without a card the
    default raises."""
    tt = timing.get(None)
    with tt.scope("generate_trace"):
        with tt.scope("inputs"):
            dev = rows.bundle([curve.ints(p) + curve.ints(o) for _, p, o, _ in inputs],
                              4 * curve.degree, [(s, t) for s, _, _, t in inputs], device)
        w = curve.degree * N_LIMBS
        x, y, ox, oy = (curve.coord(dev[:, j * w : (j + 1) * w]) for j in range(4))
        trace = generate_trace_core(curve, x, y, ox, oy, dev[:, 4 * w : 4 * w + N_BITS],
                                    dev[:, -1], min_rows)
        with tt.scope("range checks"):
            return add_range_checks(curve, trace)


def eval_scalar_mul(curve: Curve, consumer, ring, local, next_):
    """The AIR; each constraint's place in this order fixes its alpha power."""
    lv = curve.layout.view(local)
    nv = curve.layout.view(next_)
    modulus = [ring.const(m) for m in bigint.MOD_LIMBS_INT]
    one = ring.one()

    is_next_not_last = nv["filter"] - nv["round_flags"]["is_last_round"]
    is_not_last_round = lv["filter"] - lv["round_flags"]["is_last_round"]

    curve.eval_add(consumer, ring, lv["filter"], modulus, lv["a"], lv["b"], lv["c"], lv["add_aux"])
    first = lv["round_flags"]["is_first_round"]
    point = lambda v: v["x"] + v["y"]
    eval_eq(consumer, first, lv["is_adding"], one)
    eval_eq(consumer, first, point(lv["double"]), point(lv["b"]))
    first_bit0 = lv["bits"][0] * first
    first_not_bit0 = (one - lv["bits"][0]) * first
    eval_eq(consumer, first_bit0, point(lv["sum"]), point(lv["c"]))
    eval_eq(consumer, first_not_bit0, point(lv["sum"]), point(lv["a"]))

    # doubling_step -> addition_step
    dbl = lv["is_doubling_not_last"]
    eval_eq(consumer, dbl, point(nv["a"]), point(lv["sum"]))
    eval_eq(consumer, dbl, point(nv["b"]), point(lv["double"]))
    eval_eq(consumer, nv["bits"][0] * dbl, point(nv["sum"]), point(nv["c"]))
    eval_eq(consumer, (one - nv["bits"][0]) * dbl, point(nv["sum"]), point(nv["a"]))
    eval_eq(consumer, dbl, point(nv["double"]), point(lv["double"]))
    eval_eq(consumer, dbl, nv["is_adding"], one)
    eval_eq(consumer, dbl, nv["is_doubling_not_last"], ring.zero())
    eval_eq(consumer, dbl, nv["bits"], [lv["bits"][(i + 1) % N_BITS] for i in range(N_BITS)])

    # addition_step -> doubling_step
    ad = lv["is_adding"]
    eval_eq(consumer, ad, point(nv["a"]), point(lv["double"]))
    eval_eq(consumer, ad, point(nv["b"]), point(lv["double"]))
    eval_eq(consumer, ad, point(nv["sum"]), point(lv["sum"]))
    eval_eq(consumer, ad, point(nv["double"]), point(nv["c"]))
    eval_eq(consumer, ad, nv["is_adding"], ring.zero())
    eval_eq(consumer, ad, nv["is_doubling_not_last"], is_next_not_last)
    eval_eq(consumer, ad, nv["bits"], lv["bits"])

    round_flags.eval_round_flags(consumer, ring, rows.PERIOD, lv["filter"], lv["round_flags"],
                                 nv["round_flags"]["counter"])
    eval_eq(consumer, is_not_last_round, nv["timestamp"], lv["timestamp"])
    eval_eq(consumer, is_not_last_round, nv["filter"], lv["filter"])

    diff = nv["range_counter"] - lv["range_counter"]
    consumer.constraint_transition(diff * diff - diff)
    consumer.constraint_last_row(lv["range_counter"] - ring.const((1 << LIMB_BITS) - 1))


def lookups(curve: Curve):
    lay = curve.layout
    return [Lookup(columns=list(curve.range_check_cols), table_col=lay.col("range_counter"),
                   freq_col=lay.col("frequency"))]


def ctls(curve: Curve):
    lay = curve.layout
    bits, ts = lay.range("bits"), [("single", lay.col("timestamp"))]

    def single(name):
        return [("single", c) for c in lay.range(name)]

    scalar = [("le_bits", list(bits[k : k + LIMB_BITS])) for k in range(0, N_BITS, LIMB_BITS)]
    return [
        CtlSpec(columns=single("b") + single("a") + scalar + ts,
                filter_col=lay.col("round_flags", "is_first_round")),
        CtlSpec(columns=single("sum") + ts, filter_col=lay.col("round_flags", "is_last_round")),
    ]


def generate_ctl_values(curve: Curve, inputs):
    """Host CTL value rows: inputs (x, offset, scalar limbs, timestamp) and
    outputs (s * x + offset, timestamp)."""

    def limbs(p):
        return [limb for v in curve.ints(p) for limb in h_int_to_limbs(v, 16)]

    ins, outs = [], []
    with timing.get(None).scope("generate_ctl_values"):
        for s, x, offset, t in inputs:
            ins.append(limbs(x) + limbs(offset) + h_int_to_limbs(s, 16) + [t])
            outs.append(limbs(curve.add(curve.mul(x, s), offset)) + [t])
    return {0: ins, 1: outs}
