"""FqExpStark: batched x^s (BN254 Fq exponentiation) STARK machine.

Port of `plonky2_bn254_tpu/starks/fq_exp.py`.  512 rows per op,
alternating mul rows (even counter, process scalar bit 0) and square rows
(odd counter), scalar kept as 256 one-bit columns rotated left after each
square row; row width 427.

Trace generation: one Python loop of 256 steps runs the square chain and
the running product together (each step one `mulmod` over the stacked
[2, n, 16] pair), then ONE batched fq_mul witness pass covers the mul and
square rows.
"""

from __future__ import annotations

import torch

from . import bigint, fq_mul, modular, round_flags, rows
from .air import eval_eq
from .layout import Layout, MODULUS_ZERO_AUX_LAYOUT, ROUND_FLAGS_LAYOUT
from .limbs import LIMB_BITS, N_BITS, N_LIMBS

FQ_PERIOD = rows.PERIOD  # 512

LAYOUT = Layout(
    [
        ("square", N_LIMBS),
        ("product", N_LIMBS),
        ("a", N_LIMBS),
        ("b", N_LIMBS),
        ("c", N_LIMBS),
        ("mul_aux", MODULUS_ZERO_AUX_LAYOUT),
        ("bits", N_BITS),
        ("round_flags", ROUND_FLAGS_LAYOUT),
        ("timestamp", 1),
        ("is_mul", 1),
        ("is_sq_not_last", 1),
        ("filter", 1),
        ("frequency", 1),
        ("range_counter", 1),
    ]
)
assert LAYOUT.width == 427

RANGE_CHECK_COLS = range(2 * N_LIMBS, 5 * N_LIMBS + modular.MODULUS_AUX_ZERO_LEN)
FREQ_COL = LAYOUT.col("frequency")
RANGE_COUNTER_COL = LAYOUT.col("range_counter")


def _chains(x_limbs, s_bits):
    """sq_k = x^(2^k) (k = 0..256) and p_{k-1} = x^(s mod 2^k) (k = 0..256),
    each [257, n, 16]: step k squares sq_k and multiplies p_{k-1} by it in
    one stacked mulmod."""
    one = torch.zeros_like(x_limbs)
    one[..., 0] = 1
    sq, cur = x_limbs, one
    sqs, prods = [sq], [cur]
    for k in range(N_BITS):
        both = bigint.mulmod(torch.stack([cur, sq]), torch.stack([sq, sq]))
        cur = torch.where((s_bits[:, k] == 1)[:, None], both[0], cur)
        sq = both[1]
        sqs.append(sq)
        prods.append(cur)
    return torch.stack(sqs), torch.stack(prods)


def _aux_cols(aux: modular.ModulusZeroAux):
    return [aux.is_quot_positive[..., None], aux.quot_abs, aux.aux_lo, aux.aux_hi]


def generate_trace_core(x_limbs, s_bits, timestamps, min_rows: int = 0):
    """[n,16] x limbs, [n,256] scalar bits, [n] timestamps -> [num_rows, 427]
    int64 rows (range-check columns zero)."""
    sqs, prods = _chains(x_limbs, s_bits)
    sq_lo, p_prev, p_full = sqs[:N_BITS], prods[:N_BITS], prods[1:]
    # mul rows (counter 2k): a = p_{k-1}, b = sq_k; square rows: a = b = sq_k
    c, aux = fq_mul.generate_fq_mul(torch.stack([p_prev, sq_lo]), torch.stack([sq_lo, sq_lo]))
    even_tail, odd_tail = rows.tails(s_bits, timestamps)
    mul_rows = ([sq_lo, p_full, p_prev, sq_lo, c[0]]  # square col of a mul row = sq_k
                + _aux_cols(modular.index_tree(aux, 0)) + even_tail)
    sq_rows = ([c[1], p_full, sq_lo, sq_lo, c[1]]  # square col of a square row = sq_{k+1}
               + _aux_cols(modular.index_tree(aux, 1)) + odd_tail)
    return rows.assemble(mul_rows, sq_rows, min_rows)


def add_range_checks(trace: torch.Tensor) -> torch.Tensor:
    """Fill the range-check counter and frequency columns (in place)."""
    return rows.add_range_checks(trace, RANGE_CHECK_COLS, RANGE_COUNTER_COL, FREQ_COL)


def generate_trace(inputs, min_rows: int = 1 << LIMB_BITS,
                   device="cuda") -> torch.Tensor:
    """inputs: list of (s, x, timestamp) python ints -> [num_rows, 427] int64
    trace on `device`: the card unless the caller asks for the CPU
    (`device="cpu"`); without a card the default raises."""
    dev = rows.bundle([(x,) for _, x, _ in inputs], 1, [(s, t) for s, _, t in inputs], device)
    trace = generate_trace_core(dev[:, :N_LIMBS], dev[:, N_LIMBS : N_LIMBS + N_BITS],
                                dev[:, -1], min_rows)
    return add_range_checks(trace)


# ---------------------------------------------------------------------------
# AIR constraints (ring-generic)
# ---------------------------------------------------------------------------

MODULUS_INT = bigint.MOD_LIMBS_INT


def eval_fq_exp(consumer, ring, local, next_):
    lv = LAYOUT.view(local)
    nv = LAYOUT.view(next_)
    modulus = [ring.const(m) for m in MODULUS_INT]
    one = ring.one()

    is_not_last_round = lv["filter"] - lv["round_flags"]["is_last_round"]

    fq_mul.eval_fq_mul(
        consumer, ring, lv["filter"], modulus, lv["a"], lv["b"], lv["c"], lv["mul_aux"]
    )
    first = lv["round_flags"]["is_first_round"]
    eval_eq(consumer, first, lv["is_mul"], one)
    eval_eq(consumer, first, lv["square"], lv["b"])
    first_bit0 = lv["bits"][0] * first
    first_not_bit0 = (one - lv["bits"][0]) * first
    eval_eq(consumer, first_bit0, lv["product"], lv["c"])
    eval_eq(consumer, first_not_bit0, lv["product"], lv["a"])
    one_u256 = [one] + [ring.zero()] * (N_LIMBS - 1)
    eval_eq(consumer, first, lv["a"], one_u256)

    # sq_step -> mul_step
    sq = lv["is_sq_not_last"]
    eval_eq(consumer, sq, nv["a"], lv["product"])
    eval_eq(consumer, sq, nv["b"], lv["square"])
    eval_eq(consumer, nv["bits"][0] * sq, nv["product"], nv["c"])
    eval_eq(consumer, (one - nv["bits"][0]) * sq, nv["product"], nv["a"])
    eval_eq(consumer, sq, nv["square"], lv["square"])
    eval_eq(consumer, sq, nv["is_mul"], one)
    eval_eq(consumer, sq, nv["is_sq_not_last"], ring.zero())
    eval_eq(
        consumer, sq, nv["bits"],
        [lv["bits"][(i + 1) % N_BITS] for i in range(N_BITS)],
    )

    # mul_step -> sq_step
    mu = lv["is_mul"]
    is_next_not_last = nv["filter"] - nv["round_flags"]["is_last_round"]
    eval_eq(consumer, mu, nv["a"], lv["square"])
    eval_eq(consumer, mu, nv["b"], lv["square"])
    eval_eq(consumer, mu, nv["product"], lv["product"])
    eval_eq(consumer, mu, nv["square"], nv["c"])
    eval_eq(consumer, mu, nv["is_mul"], ring.zero())
    eval_eq(consumer, mu, nv["is_sq_not_last"], is_next_not_last)
    eval_eq(consumer, mu, nv["bits"], lv["bits"])

    round_flags.eval_round_flags(
        consumer,
        ring,
        FQ_PERIOD,
        lv["filter"],
        lv["round_flags"],
        nv["round_flags"]["counter"],
    )
    eval_eq(consumer, is_not_last_round, nv["timestamp"], lv["timestamp"])
    eval_eq(consumer, is_not_last_round, nv["filter"], lv["filter"])

    # range_counter monotonicity + last-row pin
    diff = nv["range_counter"] - lv["range_counter"]
    consumer.constraint_transition(diff * diff - diff)
    consumer.constraint_last_row(
        lv["range_counter"] - ring.const((1 << LIMB_BITS) - 1)
    )


# ---------------------------------------------------------------------------
# Lookup and CTL specs
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

    b0 = LAYOUT.range("b").start
    prod0 = LAYOUT.range("product").start
    bits0 = LAYOUT.range("bits").start
    ts = LAYOUT.col("timestamp")
    input_cols = [("single", b0 + i) for i in range(N_LIMBS)]
    input_cols += [
        ("le_bits", list(range(bits0 + k * LIMB_BITS, bits0 + (k + 1) * LIMB_BITS)))
        for k in range(N_BITS // LIMB_BITS)
    ]
    input_cols.append(("single", ts))
    output_cols = [("single", prod0 + i) for i in range(N_LIMBS)] + [("single", ts)]
    return [
        CtlSpec(columns=input_cols, filter_col=LAYOUT.col("round_flags", "is_first_round")),
        CtlSpec(columns=output_cols, filter_col=LAYOUT.col("round_flags", "is_last_round")),
    ]


def generate_ctl_values(inputs):
    """Host CTL value rows: inputs (x, scalar limbs, timestamp) and outputs
    (x^s, timestamp), as python-int lists."""
    from ..bn254.params import P as BN254_P
    from .limbs import h_int_to_limbs

    ins, outs = [], []
    for s, x, t in inputs:
        ins.append(h_int_to_limbs(x, 16) + h_int_to_limbs(s, 16) + [t])
        outs.append(h_int_to_limbs(pow(x, s, BN254_P), 16) + [t])
    return {0: ins, 1: outs}
