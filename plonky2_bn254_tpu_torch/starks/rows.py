"""Row assembly shared by the three 512-row machines (G1 and G2 scalar-mul,
FqExp).

Each op fills 512 rows: an even row (add or mul step, counter 2k) and an odd
row (double or square step, counter 2k + 1) for each of the 256 scalar bits,
with the bits rotated left once per round.  The machines differ only in their
leading columns; the trailing ones, the interleaving, the padding and the
range-check columns are the same, and live here.
"""

from __future__ import annotations

import numpy as np
import torch

from . import round_flags
from .histogram import bincount16
from .limbs import LIMB_BITS, N_BITS, h_bits_le, h_int_to_limbs

PERIOD = 2 * N_BITS  # 512


def bundle(rows_of_ints, n_ints: int, s_and_t, device) -> torch.Tensor:
    """One host->device transfer of every op's inputs: per op, `n_ints`
    field elements as 16 limbs each, then the scalar's 256 bits, then the
    timestamp.  `rows_of_ints[i]` lists op i's field elements and
    `s_and_t[i]` is its (scalar, timestamp)."""
    n = len(rows_of_ints)
    width = 16 * n_ints
    out = np.zeros((n, width + N_BITS + 1), dtype=np.int64)
    for i, (vals, (s, t)) in enumerate(zip(rows_of_ints, s_and_t)):
        for j, v in enumerate(vals):
            out[i, 16 * j : 16 * (j + 1)] = h_int_to_limbs(int(v))
        out[i, width : width + N_BITS] = h_bits_le(int(s))
        out[i, -1] = int(t)
    return torch.from_numpy(out).to(device)


def tails(s_bits: torch.Tensor, timestamps: torch.Tensor):
    """Trailing columns of the even and odd rows, each a list of
    [256, n, .] tensors: the bits rotated k times on round k, the round
    flags, the timestamp, is-even-step, odd-step-not-last, filter, and the
    frequency and range-counter columns (zero; `add_range_checks` fills
    them)."""
    n = s_bits.shape[0]
    dev = s_bits.device
    k_idx = torch.arange(N_BITS, device=dev)
    rot_idx = (k_idx[:, None] + k_idx[None, :]) % N_BITS
    bits_rot = s_bits[:, rot_idx].permute(1, 0, 2)  # [256, n, 256]
    flags = torch.from_numpy(round_flags.flag_tables(PERIOD).view(np.int64)).to(dev)
    even_flags = flags[0::2][:, None, :].expand(N_BITS, n, 5)
    odd_flags = flags[1::2][:, None, :].expand(N_BITS, n, 5)
    ts = timestamps[None, :, None].expand(N_BITS, n, 1)
    ones = torch.ones((N_BITS, n, 1), dtype=torch.int64, device=dev)
    zeros = torch.zeros_like(ones)
    odd_not_last = ones.clone()
    odd_not_last[N_BITS - 1] = 0
    even = [bits_rot, even_flags, ts, ones, zeros, ones, zeros, zeros]
    odd = [bits_rot, odd_flags, ts, zeros, odd_not_last, ones, zeros, zeros]
    return even, odd


def assemble(even_cols, odd_cols, min_rows: int) -> torch.Tensor:
    """Lists of [256, n, .] column blocks of the even and odd rows ->
    [num_rows, width] trace, op i on rows 512 i .. 512 i + 511 in the order
    even_0, odd_0, even_1, ...; num_rows is the power of two at least
    max(min_rows, 512 n); the padding rows are zero."""
    even = torch.cat(even_cols, dim=-1)
    steps, n, width = even.shape
    num_rows = max(min_rows, n * PERIOD)
    num_rows = 1 << (num_rows - 1).bit_length()
    trace = torch.zeros((num_rows, width), dtype=torch.int64, device=even.device)
    ops = trace[: n * PERIOD].view(n, steps, 2, width)
    ops[:, :, 0] = even.permute(1, 0, 2)
    del even
    ops[:, :, 1] = torch.cat(odd_cols, dim=-1).permute(1, 0, 2)
    return trace


def add_range_checks(trace: torch.Tensor, check_cols: range, counter_col: int,
                     freq_col: int) -> torch.Tensor:
    """Fill the range counter (0, 1, ... saturating at 2^16 - 1) and the
    frequency of each counter value among `check_cols` (in place)."""
    num_rows = trace.shape[0]
    trace[:, counter_col] = torch.arange(num_rows, device=trace.device).clamp(
        max=(1 << LIMB_BITS) - 1)
    trace[:, freq_col] = bincount16(trace[:, check_cols.start : check_cols.stop], num_rows)
    return trace
