"""NTT kernels K3 (NTT / iNTT) and K4 (coset LDE) for the H100.

Port of `plonky2_bn254_tpu/field/ntt_pallas.py` (`ntt`, `intt`,
`coset_lde_rate1`).  The kernels are `csrc/ntt.cu`; the plain versions
beside them are the tensor transforms of `ntt.py`.  Transforms run along the
last axis of `[..., n]`; a wrapper takes the plain path only for a CPU
tensor, and for a CUDA tensor it launches its kernel or raises.

This module owns the kernels' plan: the split n = n1 * n2 of a two-pass
four-step (`plan`), the lines per shared-memory tile (`lines_log`), and the
tables the kernels read (twiddles per tile size, the four-step twiddles,
the coset powers).  `emulate` runs the same passes on the same tables in
plain torch, so the CPU tests check the plan and the tables that the card
uses.
"""

from __future__ import annotations

import functools

import torch

from .. import kernels
from ..interop import tensor_from_u64
from . import goldilocks as gl
from . import ntt as ntt_plain_mod

ONE_PASS_MAX_LOG = 10  # rows of at most 2^10 words: one pass, many rows per tile
TILE_MAX_LOG = 11  # the longest transform inside one tile: two passes reach 2^22


def plan(n_log: int) -> tuple:
    """(n_log,) for one pass, else (log n1, log n2) with n = n1 * n2: pass 1
    runs the n1-point transforms down the columns of the [n1, n2] view,
    pass 2 the n2-point ones along its rows.  n1 takes the odd bit (2^17 =
    2^9 * 2^8: the LDE's pass 1 folds its first stage into the load, leaving
    two full radix-16 passes).  n2 > 2^11 only beyond 2^22, where the rows
    become a transform of their own."""
    if n_log <= ONE_PASS_MAX_LOG:
        return (n_log,)
    m1 = min(n_log - n_log // 2, TILE_MAX_LOG)
    return (m1, n_log - m1)


def lines_log(m: int, one_pass: bool) -> int:
    """log2 of the lines of 2^m words in one tile.  One pass: 256 threads of
    one radix group each.  Two passes: 16 lines (128-byte runs) while the
    tile stays within 8192 words."""
    if one_pass:
        return 8 + min(m, 4) - m
    return min(4, 13 - m)


@functools.lru_cache(maxsize=None)
def _twiddles(m: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """w_M^k for k < M/2 (w_M^-k for the inverse); one dummy word if M = 1."""
    w = gl.primitive_root_of_unity(m)
    if inverse:
        w = gl.h_inv(w)
    return tensor_from_u64(gl.powers(w, max(1, (1 << m) // 2)), device)


@functools.lru_cache(maxsize=None)
def _four_step(n_log: int, m1: int, inverse: bool, scale: bool,
               device: torch.device) -> torch.Tensor:
    """T[k1 * n2 + i2] = w_n^(k1 * i2), times n^-1 if `scale` (inverse)."""
    n = 1 << n_log
    w = gl.primitive_root_of_unity(n_log)
    if inverse:
        w = gl.h_inv(w)
    pw = tensor_from_u64(gl.powers(w, n))
    k1 = torch.arange(1 << m1)[:, None]
    i2 = torch.arange(1 << (n_log - m1))[None, :]
    t = pw[(k1 * i2) & (n - 1)].reshape(-1)
    if scale:
        t = gl.mul_const(t, pow(n, gl.P - 2, gl.P))
    return t.contiguous().to(device)


@functools.lru_cache(maxsize=None)
def _coset_table(n: int, shift: int, device: torch.device) -> torch.Tensor:
    return tensor_from_u64(ntt_plain_mod._coset_powers(n, shift), device)


def _log2(n: int, what: str) -> int:
    n_log = n.bit_length() - 1
    if n < 1 or n != 1 << n_log:
        raise ValueError(f"{what}: size {n} is not a power of two")
    return n_log


def _n_inv(n_log: int) -> int:
    return pow(1 << n_log, gl.P - 2, gl.P)


def _run(lib, x: torch.Tensor, y: torch.Tensor, n_log: int, src_log: int,
         inverse: bool, scale: bool, pre, stream: int) -> None:
    """Launch the passes of one batched transform x -> y ([rows, 2^n_log])."""
    rows = y.shape[0]
    dev = y.device
    pre_ptr = None if pre is None else pre.data_ptr()
    p = plan(n_log)
    if len(p) == 1:
        kernels.check(
            lib.p2_ntt_rows(x.data_ptr(), y.data_ptr(), _twiddles(n_log, inverse, dev).data_ptr(),
                            pre_ptr, rows, n_log, src_log, lines_log(n_log, True),
                            int(scale and n_log > 0), _n_inv(n_log), stream),
            "ntt_rows",
        )
        return
    m1, m2 = p
    tmp = torch.empty_like(y)
    kernels.check(
        lib.p2_ntt_columns(x.data_ptr(), tmp.data_ptr(), _twiddles(m1, inverse, dev).data_ptr(),
                           _four_step(n_log, m1, inverse, scale, dev).data_ptr(), pre_ptr,
                           rows, m1, m2, src_log, lines_log(m1, False), stream),
        "ntt_columns",
    )
    if m2 <= TILE_MAX_LOG:
        kernels.check(
            lib.p2_ntt_rows_t(tmp.data_ptr(), y.data_ptr(), _twiddles(m2, inverse, dev).data_ptr(),
                              rows, m1, m2, lines_log(m2, False), stream),
            "ntt_rows_t",
        )
        return
    # beyond 2^22: the n2-point row transforms on their own, then a transpose
    inner = torch.empty((rows << m1, 1 << m2), dtype=torch.int64, device=dev)
    _run(lib, tmp, inner, m2, m2, inverse, False, None, stream)
    y.view(rows, 1 << m2, 1 << m1).copy_(inner.view(rows, 1 << m1, 1 << m2).transpose(1, 2))


def _transform(x: torch.Tensor, out_n: int, inverse: bool, kernel_id: str,
               pre=None) -> torch.Tensor:
    """Run the passes of `plan` on the card and count one launch of
    `kernel_id`, keyed (rows, n in, n out, inverse).  `pre`: coset powers
    for the LDE premultiply."""
    lib = kernels.library()
    rows = x.shape[0]
    n_log = _log2(out_n, "ntt")
    src_log = _log2(x.shape[1], "ntt")
    y = torch.empty((rows, out_n), dtype=torch.int64, device=x.device)
    if rows == 0:
        return y
    _run(lib, x, y, n_log, src_log, inverse, inverse, pre, kernels.stream_of(x))
    kernels.count_launch(kernel_id, (rows, x.shape[1], out_n, inverse))
    return y


# ---------------------------------------------------------------------------
# The kernels' algorithm in plain torch (CPU tests of the plan and tables)
# ---------------------------------------------------------------------------


def _dif_natural(v: torch.Tensor, m: int, tw: torch.Tensor) -> torch.Tensor:
    """2^m-point transforms along the last axis as the tiles run them:
    radix-2 DIF stages on the twiddles w_M^k, then natural order."""
    lead = v.shape[:-1]
    for j in range(m - 1, -1, -1):
        h = 1 << j
        pairs = v.reshape(lead + (-1, 2, h))
        a, b = pairs[..., 0, :], pairs[..., 1, :]
        t = tw[torch.arange(h) << (m - 1 - j)]
        v = torch.stack([gl.add(a, b), gl.mul(gl.sub(a, b), t)], dim=-2).reshape(lead + (-1,))
    return v[..., torch.from_numpy(ntt_plain_mod._bit_reverse_perm(m))]


def _emulate_passes(x: torch.Tensor, n_log: int, inverse: bool, scale: bool) -> torch.Tensor:
    rows = x.shape[0]
    p = plan(n_log)
    if len(p) == 1:
        y = _dif_natural(x, n_log, _twiddles(n_log, inverse, x.device))
        return gl.mul_const(y, _n_inv(n_log)) if scale and n_log > 0 else y
    m1, m2 = p
    cols = x.reshape(rows, 1 << m1, 1 << m2).transpose(1, 2)
    y = _dif_natural(cols, m1, _twiddles(m1, inverse, x.device)).transpose(1, 2)
    y = gl.mul(y.reshape(rows, -1), _four_step(n_log, m1, inverse, scale, x.device))
    y = y.reshape(rows << m1, 1 << m2)
    if m2 <= TILE_MAX_LOG:
        z = _dif_natural(y, m2, _twiddles(m2, inverse, x.device))
    else:
        z = _emulate_passes(y, m2, inverse, False)
    return z.reshape(rows, 1 << m1, 1 << m2).transpose(1, 2).reshape(rows, -1)


def emulate(x: torch.Tensor, inverse: bool = False, rate_bits: int = None,
            shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR) -> torch.Tensor:
    """[w, n] -> the kernels' result, in plain torch on the kernels' plan and
    tables: NTT, iNTT, or with `rate_bits` the coset LDE."""
    n = x.shape[-1]
    if rate_bits is not None:
        pre = _coset_table(n, shift, x.device)
        x = torch.cat([gl.mul(x, pre), x.new_zeros((x.shape[0], (n << rate_bits) - n))], dim=-1)
    return _emulate_passes(x, _log2(x.shape[-1], "ntt"), inverse, inverse)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _as_rows(x: torch.Tensor, name: str):
    if x.dim() < 1:
        raise ValueError(f"{name}: expected at least one axis")
    return x.reshape(-1, x.shape[-1]), x.shape[:-1]


def ntt_plain(x: torch.Tensor) -> torch.Tensor:
    return ntt_plain_mod.ntt(x)


def intt_plain(x: torch.Tensor) -> torch.Tensor:
    return ntt_plain_mod.intt(x)


def coset_lde_plain(coeffs: torch.Tensor, rate_bits: int,
                    shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR) -> torch.Tensor:
    return ntt_plain_mod.coset_lde_from_coeffs(coeffs, rate_bits, shift)


def _ntt_kernel(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    kernels.require_cuda_int64(x, "intt" if inverse else "ntt")
    rows, lead = _as_rows(x, "ntt")
    y = _transform(rows, rows.shape[1], inverse, "K3")
    return y.reshape(lead + (x.shape[-1],))


def ntt(x: torch.Tensor) -> torch.Tensor:
    """Forward NTT along the last axis, natural order in and out (K3)."""
    if kernels.is_plain(x):
        return ntt_plain(x)
    return _ntt_kernel(x, inverse=False)


def intt(x: torch.Tensor) -> torch.Tensor:
    """Inverse NTT along the last axis, natural order in and out (K3)."""
    if kernels.is_plain(x):
        return intt_plain(x)
    return _ntt_kernel(x, inverse=True)


def coset_lde(coeffs: torch.Tensor, rate_bits: int,
              shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR) -> torch.Tensor:
    """[..., n] coefficients -> [..., n << rate_bits] values on shift * H (K4)."""
    if kernels.is_plain(coeffs):
        return coset_lde_plain(coeffs, rate_bits, shift)
    kernels.require_cuda_int64(coeffs, "coset_lde")
    rows, lead = _as_rows(coeffs, "coset_lde")
    n = rows.shape[1]
    pre = _coset_table(n, shift, coeffs.device)
    y = _transform(rows, n << rate_bits, False, "K4", pre=pre)
    return y.reshape(lead + (n << rate_bits,))
