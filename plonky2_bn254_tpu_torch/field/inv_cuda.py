"""Batch-inversion kernel K6 for the H100.

`batch_inv(x)` inverts every element of `x` (0 -> 0): for a CUDA tensor in
one launch of `csrc/inverse.cu`, for a CPU tensor by the plain version
beside it, `goldilocks.batch_inv` (Montgomery's trick in tensor operations).
Any shape is taken as one flat vector; an inverse is unique, so both give
the same canonical residues on canonical input.

`emulate` runs the kernel's schedule in plain torch: tiles of BLOCK
elements, thread t's run the elements t, t + THREADS, ... of its tile, the
runs' prefix products, the shuffle scans over the lanes of a warp and over
the warps, each tile's one Fermat chain (`fermat_inverse`, the kernel's
addition chain), the walk back down.  The CPU tests hold it against the
plain version, so they check the schedule that the card runs.
"""

from __future__ import annotations

import torch

from .. import kernels
from . import goldilocks as gl

THREADS = 256  # csrc/inverse.cu's geometry (`p2_batch_inverse_block`)
PER_THREAD = 16
WARP = 32
WARPS = THREADS // WARP
BLOCK = THREADS * PER_THREAD


def batch_inv_plain(x: torch.Tensor) -> torch.Tensor:
    return gl.batch_inv(x)


def batch_inv(x: torch.Tensor) -> torch.Tensor:
    """Elementwise inverse mod p (0 -> 0) of a tensor of any shape (K6)."""
    if kernels.is_plain(x):
        return batch_inv_plain(x)
    kernels.require_cuda_int64(x, "batch_inv")
    y = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return y
    lib = kernels.library()
    kernels.check(lib.p2_batch_inverse(x.data_ptr(), y.data_ptr(), n, kernels.stream_of(x)),
                  "batch_inverse")
    kernels.count_launch("K6", (n,))
    return y


# ---------------------------------------------------------------------------
# The kernel's schedule in plain torch (CPU tests)
# ---------------------------------------------------------------------------


def _sqn(x: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        x = gl.square(x)
    return x


def fermat_inverse(x: torch.Tensor) -> torch.Tensor:
    """x^(p - 2) by the kernel's addition chain: p - 2 = (2^31 - 1) 2^33 +
    (2^32 - 1), with e_k = x^(2^k - 1) and e_(j+k) = e_j^(2^k) e_k."""
    e2 = gl.mul(_sqn(x, 1), x)
    e3 = gl.mul(_sqn(e2, 1), x)
    e6 = gl.mul(_sqn(e3, 3), e3)
    e12 = gl.mul(_sqn(e6, 6), e6)
    e24 = gl.mul(_sqn(e12, 12), e12)
    e30 = gl.mul(_sqn(e24, 6), e6)
    e31 = gl.mul(_sqn(e30, 1), x)
    e32 = gl.mul(_sqn(e31, 1), x)
    return gl.mul(_sqn(e31, 33), e32)


def _others(v: torch.Tensor) -> tuple:
    """[..., width] values of the lanes of a segment -> (each lane's product
    of the other lanes' values, the segment's product), by the kernel's
    shuffle scans up and down the segment."""
    width = v.shape[-1]
    pos = torch.arange(width)
    up = down = v
    d = 1
    while d < width:
        up = torch.where(pos >= d, gl.mul(up, torch.roll(up, d, -1)), up)
        down = torch.where(pos + d < width, gl.mul(down, torch.roll(down, -d, -1)), down)
        d *= 2
    below = torch.where(pos == 0, 1, torch.roll(up, 1, -1))
    above = torch.where(pos == width - 1, 1, torch.roll(down, -1, -1))
    return gl.mul(below, above), up[..., -1]


def emulate(x: torch.Tensor) -> torch.Tensor:
    """`batch_inv` by K6's schedule in plain torch; inputs reduced mod p."""
    flat = x.reshape(-1)
    n = flat.numel()
    tiles = -(-n // BLOCK)
    v = torch.where(gl._ge_p(flat), flat - gl._P, flat)
    v = torch.cat([v, v.new_ones(tiles * BLOCK - n)])
    zero = v == 0
    a = torch.where(zero, 1, v).reshape(tiles, PER_THREAD, THREADS)  # [tile, k, thread]
    c = [a[:, 0]]
    for k in range(1, PER_THREAD):
        c.append(gl.mul(c[-1], a[:, k]))
    lane_others, warp_total = _others(c[-1].reshape(tiles, WARPS, WARP))
    warp_others, product = _others(warp_total)
    warp_inv = gl.mul(warp_others, fermat_inverse(product)[:, None])
    inv_c = gl.mul(warp_inv[..., None], lane_others).reshape(tiles, THREADS)
    out = [None] * PER_THREAD
    for k in reversed(range(PER_THREAD)):
        out[k] = gl.mul(inv_c, c[k - 1]) if k else inv_c
        if k:
            inv_c = gl.mul(inv_c, a[:, k])
    y = torch.where(zero, 0, torch.stack(out, 1).reshape(-1))
    return y[:n].reshape(x.shape)
