"""G2ScalarMulStark: batched s*x + offset over the BN254 twist (Fq2).

Port of `plonky2_bn254_tpu/starks/g2_scalar_mul.py`: the machine shape of
G1 with the Fq2 limb algebra substituted; row width 1295.

Trace generation: inversion-free Jacobian chains over Fq2 (Python loops of
256 steps, each a few stacked `fq2_alg` products and reductions), one
batched inversion per chain to normalise every point, then ONE batched
g2_add witness pass over the add and double rows together.
"""

from __future__ import annotations

import torch

from . import bigint, fq2_alg, g2_add, modular, round_flags, rows
from .air import eval_eq
from .layout import Layout, ROUND_FLAGS_LAYOUT
from .limbs import LIMB_BITS, N_BITS, N_LIMBS

G2_PERIOD = rows.PERIOD  # 512
G2_LEN = g2_add.G2_LEN  # 64

POINT2 = Layout([("x", 2 * N_LIMBS), ("y", 2 * N_LIMBS)])

LAYOUT = Layout(
    [
        ("double", POINT2),
        ("sum", POINT2),
        ("a", POINT2),
        ("b", POINT2),
        ("c", POINT2),
        ("add_aux", g2_add.G2_ADD_AUX_LAYOUT),
        ("bits", N_BITS),
        ("round_flags", ROUND_FLAGS_LAYOUT),
        ("timestamp", 1),
        ("is_adding", 1),
        ("is_doubling_not_last", 1),
        ("filter", 1),
        ("frequency", 1),
        ("range_counter", 1),
    ]
)
assert LAYOUT.width == 1295

RANGE_CHECK_COLS = range(2 * G2_LEN, 5 * G2_LEN + g2_add.G2_ADD_AUX_LEN)
FREQ_COL = LAYOUT.col("frequency")
RANGE_COUNTER_COL = LAYOUT.col("range_counter")


def _chains(x, y, ox, oy, s_bits):
    """Jacobian chains + batched affine normalisation, on [2, n, 16] Fq2
    inputs.

    Returns affine doubles d_k = 2^k x (k = 0..256), running sums
    p_k = offset + sum_{i<=k, bit_i} d_i (k = 0..255) and p_{k-1}
    (k = 0..255, p_{-1} = offset), each [2, steps, n, 16]."""
    one = torch.zeros_like(x)
    one[0, ..., 0] = 1

    X, Y, Z = x, y, one
    dX, dY, dZ = [X], [Y], [Z]
    for _ in range(N_BITS):
        X, Y, Z = fq2_alg.jac_double(X, Y, Z)
        dX.append(X)
        dY.append(Y)
        dZ.append(Z)
    d_ax, d_ay = fq2_alg.jac_to_affine(torch.stack(dX, 1), torch.stack(dY, 1),
                                       torch.stack(dZ, 1))

    X, Y, Z = ox, oy, one
    pX, pY, pZ = [], [], []
    for k in range(N_BITS):
        Xa, Ya, Za = fq2_alg.jac_mixed_add(X, Y, Z, d_ax[:, k], d_ay[:, k])
        sel = (s_bits[:, k] == 1)[:, None]
        X = torch.where(sel, Xa, X)
        Y = torch.where(sel, Ya, Y)
        Z = torch.where(sel, Za, Z)
        pX.append(X)
        pY.append(Y)
        pZ.append(Z)
    p_ax, p_ay = fq2_alg.jac_to_affine(torch.stack(pX, 1), torch.stack(pY, 1),
                                       torch.stack(pZ, 1))
    # p_{k-1}: the offset (affine already) then p_0 .. p_254
    pp_ax = torch.cat([ox[:, None], p_ax[:, :-1]], dim=1)
    pp_ay = torch.cat([oy[:, None], p_ay[:, :-1]], dim=1)
    return d_ax, d_ay, p_ax, p_ay, pp_ax, pp_ay


def _aux_cols(aux: g2_add.G2AddAux):
    def mz(m):
        return [m.is_quot_positive[..., None], m.quot_abs, m.aux_lo, m.aux_hi]

    def imz(m):
        return [m.inv] + mz(m.modulus_zero_aux)

    def ext(e):
        return mz(e.c0_aux) + mz(e.c1_aux)

    return (
        [
            aux.is_x_eq[..., None],
            aux.is_x_eq_aux.is_c0_zero[..., None],
            aux.is_x_eq_aux.is_c1_zero[..., None],
        ]
        + imz(aux.is_x_eq_aux.c0_aux)
        + imz(aux.is_x_eq_aux.c1_aux)
        + [aux.is_x_eq_filter[..., None], aux.lam[0], aux.lam[1]]
        + ext(aux.lambda_aux)
        + ext(aux.x_aux)
        + ext(aux.y_aux)
    )


def _pt(x, y):
    """[2, ...] Fq2 coordinates -> the point's four 16-limb column blocks."""
    return [x[0], x[1], y[0], y[1]]


def generate_trace_core(x, y, ox, oy, s_bits, timestamps, min_rows: int = 0):
    """[2, n, 16] Fq2 coordinates of x and the offset, [n, 256] bits, [n] ts
    -> [num_rows, 1295] int64 rows (range-check columns zero)."""
    d_ax, d_ay, p_ax, p_ay, pp_ax, pp_ay = _chains(x, y, ox, oy, s_bits)
    d_lo_ax, d_lo_ay = d_ax[:, :N_BITS], d_ay[:, :N_BITS]
    # add rows: p_{k-1} + d_k; double rows: d_k + d_k — one batched pass
    cx, cy, aux = g2_add.generate_g2_add(
        torch.stack([pp_ax, d_lo_ax], 1), torch.stack([pp_ay, d_lo_ay], 1),
        torch.stack([d_lo_ax, d_lo_ax], 1), torch.stack([d_lo_ay, d_lo_ay], 1),
    )
    even_tail, odd_tail = rows.tails(s_bits, timestamps)
    add_rows = (
        _pt(d_lo_ax, d_lo_ay) + _pt(p_ax, p_ay)  # double, sum
        + _pt(pp_ax, pp_ay) + _pt(d_lo_ax, d_lo_ay) + _pt(cx[:, 0], cy[:, 0])  # a, b, c
        + _aux_cols(modular.index_tree(aux, 0)) + even_tail
    )
    dbl_rows = (
        _pt(d_ax[:, 1:], d_ay[:, 1:]) + _pt(p_ax, p_ay)  # double = d_{k+1}, sum = p_k
        + _pt(d_lo_ax, d_lo_ay) + _pt(d_lo_ax, d_lo_ay) + _pt(cx[:, 1], cy[:, 1])
        + _aux_cols(modular.index_tree(aux, 1)) + odd_tail
    )
    return rows.assemble(add_rows, dbl_rows, min_rows)


def add_range_checks(trace: torch.Tensor) -> torch.Tensor:
    """Fill the range-check counter and frequency columns (in place)."""
    return rows.add_range_checks(trace, RANGE_CHECK_COLS, RANGE_COUNTER_COL, FREQ_COL)


def generate_trace(inputs, min_rows: int = 1 << LIMB_BITS,
                   device="cuda") -> torch.Tensor:
    """inputs: list of (s, ((x0, x1), (y0, y1)), ((ox0, ox1), (oy0, oy1)),
    timestamp) python ints -> [num_rows, 1295] int64 trace on `device`: the
    card unless the caller asks for the CPU (`device="cpu"`); without a card
    the default raises."""
    dev = rows.bundle(
        [(p[0][0], p[0][1], p[1][0], p[1][1], o[0][0], o[0][1], o[1][0], o[1][1])
         for _, p, o, _ in inputs],
        8, [(s, t) for s, _, _, t in inputs], device)
    f2 = [dev[:, 2 * j * N_LIMBS : (2 * j + 2) * N_LIMBS].reshape(-1, 2, N_LIMBS).transpose(0, 1)
          for j in range(4)]  # x, y, ox, oy as [2, n, 16]
    trace = generate_trace_core(*f2, dev[:, 8 * N_LIMBS : 8 * N_LIMBS + N_BITS], dev[:, -1],
                                min_rows)
    return add_range_checks(trace)


# ---------------------------------------------------------------------------
# AIR constraints
# ---------------------------------------------------------------------------


def eval_g2_scalar_mul(consumer, ring, local, next_):
    lv = LAYOUT.view(local)
    nv = LAYOUT.view(next_)
    modulus = [ring.const(m) for m in bigint.MOD_LIMBS_INT]
    one = ring.one()

    is_not_last_round = lv["filter"] - lv["round_flags"]["is_last_round"]
    is_next_not_last = nv["filter"] - nv["round_flags"]["is_last_round"]

    g2_add.eval_g2_add(
        consumer, ring, lv["filter"], modulus, lv["a"], lv["b"], lv["c"], lv["add_aux"]
    )
    first = lv["round_flags"]["is_first_round"]
    point = lambda v: v["x"] + v["y"]
    eval_eq(consumer, first, lv["is_adding"], one)
    eval_eq(consumer, first, point(lv["double"]), point(lv["b"]))
    first_bit0 = lv["bits"][0] * first
    first_not_bit0 = (one - lv["bits"][0]) * first
    eval_eq(consumer, first_bit0, point(lv["sum"]), point(lv["c"]))
    eval_eq(consumer, first_not_bit0, point(lv["sum"]), point(lv["a"]))

    dbl = lv["is_doubling_not_last"]
    eval_eq(consumer, dbl, point(nv["a"]), point(lv["sum"]))
    eval_eq(consumer, dbl, point(nv["b"]), point(lv["double"]))
    eval_eq(consumer, nv["bits"][0] * dbl, point(nv["sum"]), point(nv["c"]))
    eval_eq(consumer, (one - nv["bits"][0]) * dbl, point(nv["sum"]), point(nv["a"]))
    eval_eq(consumer, dbl, point(nv["double"]), point(lv["double"]))
    eval_eq(consumer, dbl, nv["is_adding"], one)
    eval_eq(consumer, dbl, nv["is_doubling_not_last"], ring.zero())
    eval_eq(
        consumer, dbl, nv["bits"],
        [lv["bits"][(i + 1) % N_BITS] for i in range(N_BITS)],
    )

    ad = lv["is_adding"]
    eval_eq(consumer, ad, point(nv["a"]), point(lv["double"]))
    eval_eq(consumer, ad, point(nv["b"]), point(lv["double"]))
    eval_eq(consumer, ad, point(nv["sum"]), point(lv["sum"]))
    eval_eq(consumer, ad, point(nv["double"]), point(nv["c"]))
    eval_eq(consumer, ad, nv["is_adding"], ring.zero())
    eval_eq(consumer, ad, nv["is_doubling_not_last"], is_next_not_last)
    eval_eq(consumer, ad, nv["bits"], lv["bits"])

    round_flags.eval_round_flags(
        consumer,
        ring,
        G2_PERIOD,
        lv["filter"],
        lv["round_flags"],
        nv["round_flags"]["counter"],
    )
    eval_eq(consumer, is_not_last_round, nv["timestamp"], lv["timestamp"])
    eval_eq(consumer, is_not_last_round, nv["filter"], lv["filter"])

    diff = nv["range_counter"] - lv["range_counter"]
    consumer.constraint_transition(diff * diff - diff)
    consumer.constraint_last_row(
        lv["range_counter"] - ring.const((1 << LIMB_BITS) - 1)
    )


# ---------------------------------------------------------------------------
# Lookup / CTL specs
# ---------------------------------------------------------------------------


def lookups():
    from .table import Lookup

    return [
        Lookup(
            columns=list(RANGE_CHECK_COLS),
            table_col=RANGE_COUNTER_COL,
            freq_col=FREQ_COL,
        )
    ]


def ctls():
    from .table import CtlSpec

    a0 = LAYOUT.range("a").start
    b0 = LAYOUT.range("b").start
    sum0 = LAYOUT.range("sum").start
    bits0 = LAYOUT.range("bits").start
    ts = LAYOUT.col("timestamp")
    input_cols = [("single", b0 + i) for i in range(G2_LEN)]
    input_cols += [("single", a0 + i) for i in range(G2_LEN)]
    input_cols += [
        ("le_bits", list(range(bits0 + k * LIMB_BITS, bits0 + (k + 1) * LIMB_BITS)))
        for k in range(N_BITS // LIMB_BITS)
    ]
    input_cols.append(("single", ts))
    output_cols = [("single", sum0 + i) for i in range(G2_LEN)] + [("single", ts)]
    return [
        CtlSpec(columns=input_cols, filter_col=LAYOUT.col("round_flags", "is_first_round")),
        CtlSpec(columns=output_cols, filter_col=LAYOUT.col("round_flags", "is_last_round")),
    ]


def generate_ctl_values(inputs):
    """Host CTL value rows: inputs (x, offset, scalar limbs, timestamp) and
    outputs (s * x + offset, timestamp)."""
    from ..bn254 import oracle
    from .limbs import h_int_to_limbs

    def pt_limbs(p):
        return (
            h_int_to_limbs(p[0][0], 16)
            + h_int_to_limbs(p[0][1], 16)
            + h_int_to_limbs(p[1][0], 16)
            + h_int_to_limbs(p[1][1], 16)
        )

    ins, outs = [], []
    for s, x, offset, t in inputs:
        ins.append(pt_limbs(x) + pt_limbs(offset) + h_int_to_limbs(s, 16) + [t])
        out_pt = oracle.g2_add(oracle.g2_mul(x, s), offset)
        outs.append(pt_limbs(out_pt) + [t])
    return {0: ins, 1: outs}
