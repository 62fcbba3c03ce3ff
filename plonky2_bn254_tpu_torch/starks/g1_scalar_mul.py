"""G1ScalarMulStark: batched s*x + offset (BN254 G1) STARK machine.

Port of `plonky2_bn254_tpu/starks/g1_scalar_mul.py`.  512 rows per op,
alternating add rows (even counter, process scalar bit 0) and double rows
(odd counter), scalar bits rotated left after each double row; row width
781.

Trace generation: inversion-free Jacobian chains (a python loop of
batched limb ops, 256 steps each), batched Fermat inversions to normalise
every point, then ONE batched g1_add witness pass over the add and double
rows together.
"""

from __future__ import annotations

import torch

from . import bigint, g1_add, jacobian, modular, round_flags, rows
from .air import eval_eq
from .layout import G1_ADD_AUX_LAYOUT, Layout, ROUND_FLAGS_LAYOUT
from .limbs import LIMB_BITS, N_BITS, N_LIMBS

G1_PERIOD = rows.PERIOD  # 512
G1_LEN = g1_add.G1_LEN  # 32

POINT = Layout([("x", N_LIMBS), ("y", N_LIMBS)])

LAYOUT = Layout(
    [
        ("double", POINT),
        ("sum", POINT),
        ("a", POINT),
        ("b", POINT),
        ("c", POINT),
        ("add_aux", G1_ADD_AUX_LAYOUT),
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
assert LAYOUT.width == 781

RANGE_CHECK_COLS = range(2 * G1_LEN, 5 * G1_LEN + g1_add.G1_ADD_AUX_LEN)
FREQ_COL = LAYOUT.col("frequency")
RANGE_COUNTER_COL = LAYOUT.col("range_counter")


def _chains(x_limbs, y_limbs, ox_limbs, oy_limbs, s_bits):
    """Jacobian chains + batched affine normalisation.

    Returns affine doubles d_k = 2^k x (k = 0..256), running sums
    p_k = offset + sum_{i<=k, bit_i} d_i (k = 0..255) and p_{k-1}
    (k = 0..255, p_{-1} = offset), each [steps, n, 16]."""
    one_limb = torch.zeros_like(x_limbs)
    one_limb[..., 0] = 1

    X, Y, Z = x_limbs, y_limbs, one_limb
    dX, dY, dZ = [X], [Y], [Z]
    for _ in range(N_BITS):
        X, Y, Z = jacobian.double(X, Y, Z)
        dX.append(X)
        dY.append(Y)
        dZ.append(Z)
    d_ax, d_ay = jacobian.to_affine(torch.stack(dX), torch.stack(dY), torch.stack(dZ))

    X, Y, Z = ox_limbs, oy_limbs, one_limb
    pX, pY, pZ = [], [], []
    for k in range(N_BITS):
        Xa, Ya, Za = jacobian.mixed_add(X, Y, Z, d_ax[k], d_ay[k])
        sel = (s_bits[:, k] == 1)[:, None]
        X = torch.where(sel, Xa, X)
        Y = torch.where(sel, Ya, Y)
        Z = torch.where(sel, Za, Z)
        pX.append(X)
        pY.append(Y)
        pZ.append(Z)
    p_ax, p_ay = jacobian.to_affine(torch.stack(pX), torch.stack(pY), torch.stack(pZ))
    # p_{k-1}: the offset (affine already) then p_0 .. p_254
    pp_ax = torch.cat([ox_limbs[None], p_ax[:-1]])
    pp_ay = torch.cat([oy_limbs[None], p_ay[:-1]])
    return d_ax, d_ay, p_ax, p_ay, pp_ax, pp_ay


def _aux_cols(aux: g1_add.G1AddAux):
    return [
        aux.is_x_eq[..., None],
        aux.is_x_eq_aux.inv,
        aux.is_x_eq_aux.modulus_zero_aux.is_quot_positive[..., None],
        aux.is_x_eq_aux.modulus_zero_aux.quot_abs,
        aux.is_x_eq_aux.modulus_zero_aux.aux_lo,
        aux.is_x_eq_aux.modulus_zero_aux.aux_hi,
        aux.is_x_eq_filter[..., None],
        aux.lam,
    ] + [
        arr
        for mz in (aux.lambda_aux, aux.x_aux, aux.y_aux)
        for arr in (mz.is_quot_positive[..., None], mz.quot_abs, mz.aux_lo, mz.aux_hi)
    ]


def generate_trace_core(x_limbs, y_limbs, ox_limbs, oy_limbs, s_bits, timestamps,
                        min_rows: int = 0):
    """[n,16] x/y/offset limbs, [n,256] bits, [n] ts -> [num_rows, 781]
    int64 rows (range-check columns zero)."""
    d_ax, d_ay, p_ax, p_ay, pp_ax, pp_ay = _chains(x_limbs, y_limbs, ox_limbs, oy_limbs,
                                                   s_bits)
    d_lo_ax, d_lo_ay = d_ax[:N_BITS], d_ay[:N_BITS]
    # add rows: p_{k-1} + d_k; double rows: d_k + d_k — one batched pass
    cx, cy, aux = g1_add.generate_g1_add(
        torch.stack([pp_ax, d_lo_ax]), torch.stack([pp_ay, d_lo_ay]),
        torch.stack([d_lo_ax, d_lo_ax]), torch.stack([d_lo_ay, d_lo_ay]),
    )
    even_tail, odd_tail = rows.tails(s_bits, timestamps)
    add_rows = (
        [d_lo_ax, d_lo_ay, p_ax, p_ay]  # double, sum
        + [pp_ax, pp_ay, d_lo_ax, d_lo_ay, cx[0], cy[0]]  # a, b, c
        + _aux_cols(modular.index_tree(aux, 0)) + even_tail
    )
    dbl_rows = (
        [d_ax[1:], d_ay[1:], p_ax, p_ay]  # double = d_{k+1}, sum = p_k
        + [d_lo_ax, d_lo_ay, d_lo_ax, d_lo_ay, cx[1], cy[1]]
        + _aux_cols(modular.index_tree(aux, 1)) + odd_tail
    )
    return rows.assemble(add_rows, dbl_rows, min_rows)


def add_range_checks(trace: torch.Tensor) -> torch.Tensor:
    """Fill the range-check counter and frequency columns (in place)."""
    return rows.add_range_checks(trace, RANGE_CHECK_COLS, RANGE_COUNTER_COL, FREQ_COL)


def generate_trace(inputs, min_rows: int = 1 << LIMB_BITS,
                   device="cuda") -> torch.Tensor:
    """inputs: list of (s, (x, y), (ox, oy), timestamp) python ints ->
    [num_rows, 781] int64 trace on `device`: the card unless the caller
    asks for the CPU (`device="cpu"`); without a card the default raises."""
    dev = rows.bundle([(p[0], p[1], o[0], o[1]) for _, p, o, _ in inputs], 4,
                      [(s, t) for s, _, _, t in inputs], device)
    trace = generate_trace_core(
        dev[:, :N_LIMBS], dev[:, N_LIMBS : 2 * N_LIMBS],
        dev[:, 2 * N_LIMBS : 3 * N_LIMBS], dev[:, 3 * N_LIMBS : 4 * N_LIMBS],
        dev[:, 4 * N_LIMBS : 4 * N_LIMBS + N_BITS], dev[:, -1], min_rows,
    )
    return add_range_checks(trace)


# ---------------------------------------------------------------------------
# AIR constraints
# ---------------------------------------------------------------------------


def eval_g1_scalar_mul(consumer, ring, local, next_):
    lv = LAYOUT.view(local)
    nv = LAYOUT.view(next_)
    modulus = [ring.const(m) for m in bigint.MOD_LIMBS_INT]
    one = ring.one()

    is_next_not_last = nv["filter"] - nv["round_flags"]["is_last_round"]
    is_not_last_round = lv["filter"] - lv["round_flags"]["is_last_round"]

    g1_add.eval_g1_add(
        consumer, ring, lv["filter"], modulus, lv["a"], lv["b"], lv["c"], lv["add_aux"]
    )
    first = lv["round_flags"]["is_first_round"]
    eval_eq(consumer, first, lv["is_adding"], one)
    eval_eq(consumer, first, lv["double"]["x"] + lv["double"]["y"], lv["b"]["x"] + lv["b"]["y"])
    first_bit0 = lv["bits"][0] * first
    first_not_bit0 = (one - lv["bits"][0]) * first
    eval_eq(consumer, first_bit0, lv["sum"]["x"] + lv["sum"]["y"], lv["c"]["x"] + lv["c"]["y"])
    eval_eq(consumer, first_not_bit0, lv["sum"]["x"] + lv["sum"]["y"], lv["a"]["x"] + lv["a"]["y"])

    # doubling_step -> addition_step
    dbl = lv["is_doubling_not_last"]
    eval_eq(consumer, dbl, nv["a"]["x"] + nv["a"]["y"], lv["sum"]["x"] + lv["sum"]["y"])
    eval_eq(consumer, dbl, nv["b"]["x"] + nv["b"]["y"], lv["double"]["x"] + lv["double"]["y"])
    eval_eq(consumer, nv["bits"][0] * dbl, nv["sum"]["x"] + nv["sum"]["y"], nv["c"]["x"] + nv["c"]["y"])
    eval_eq(
        consumer,
        (one - nv["bits"][0]) * dbl,
        nv["sum"]["x"] + nv["sum"]["y"],
        nv["a"]["x"] + nv["a"]["y"],
    )
    eval_eq(consumer, dbl, nv["double"]["x"] + nv["double"]["y"], lv["double"]["x"] + lv["double"]["y"])
    eval_eq(consumer, dbl, nv["is_adding"], one)
    eval_eq(consumer, dbl, nv["is_doubling_not_last"], ring.zero())
    eval_eq(
        consumer, dbl, nv["bits"],
        [lv["bits"][(i + 1) % N_BITS] for i in range(N_BITS)],
    )

    # addition_step -> doubling_step
    ad = lv["is_adding"]
    eval_eq(consumer, ad, nv["a"]["x"] + nv["a"]["y"], lv["double"]["x"] + lv["double"]["y"])
    eval_eq(consumer, ad, nv["b"]["x"] + nv["b"]["y"], lv["double"]["x"] + lv["double"]["y"])
    eval_eq(consumer, ad, nv["sum"]["x"] + nv["sum"]["y"], lv["sum"]["x"] + lv["sum"]["y"])
    eval_eq(consumer, ad, nv["double"]["x"] + nv["double"]["y"], nv["c"]["x"] + nv["c"]["y"])
    eval_eq(consumer, ad, nv["is_adding"], ring.zero())
    eval_eq(consumer, ad, nv["is_doubling_not_last"], is_next_not_last)
    eval_eq(consumer, ad, nv["bits"], lv["bits"])

    round_flags.eval_round_flags(
        consumer,
        ring,
        G1_PERIOD,
        lv["filter"],
        lv["round_flags"],
        nv["round_flags"]["counter"],
    )
    eval_eq(consumer, is_not_last_round, nv["timestamp"], lv["timestamp"])
    eval_eq(consumer, is_not_last_round, nv["filter"], lv["filter"])

    diff = nv["range_counter"] - lv["range_counter"]
    consumer.constraint_transition(diff * diff - diff)
    consumer.constraint_last_row(lv["range_counter"] - ring.const((1 << LIMB_BITS) - 1))


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
    input_cols = [("single", b0 + i) for i in range(G1_LEN)]
    input_cols += [("single", a0 + i) for i in range(G1_LEN)]
    input_cols += [
        ("le_bits", list(range(bits0 + k * LIMB_BITS, bits0 + (k + 1) * LIMB_BITS)))
        for k in range(N_BITS // LIMB_BITS)
    ]
    input_cols.append(("single", ts))
    output_cols = [("single", sum0 + i) for i in range(G1_LEN)] + [("single", ts)]
    return [
        CtlSpec(columns=input_cols, filter_col=LAYOUT.col("round_flags", "is_first_round")),
        CtlSpec(columns=output_cols, filter_col=LAYOUT.col("round_flags", "is_last_round")),
    ]


def generate_ctl_values(inputs):
    """Host CTL value rows: inputs (x, offset, scalar limbs, timestamp) and
    outputs (s * x + offset, timestamp)."""
    from ..bn254 import oracle
    from .limbs import h_int_to_limbs

    ins, outs = [], []
    for s, x, offset, t in inputs:
        row = (
            h_int_to_limbs(x[0], 16)
            + h_int_to_limbs(x[1], 16)
            + h_int_to_limbs(offset[0], 16)
            + h_int_to_limbs(offset[1], 16)
            + h_int_to_limbs(s, 16)
            + [t]
        )
        ins.append(row)
        out_pt = oracle.g1_add(oracle.g1_mul(x, s), offset)
        outs.append(h_int_to_limbs(out_pt[0], 16) + h_int_to_limbs(out_pt[1], 16) + [t])
    return {0: ins, 1: outs}
