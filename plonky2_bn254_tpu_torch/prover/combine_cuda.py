"""Extension-weighted sums kernel K7: the openings and the FRI oracle's
combination in a few launches.

`openings(coeffs, points, offsets)` (K7r) gives f_i(z) for every row of a
[k, n] coefficient batch at two points at once (zeta and zeta g); `oracle(...)` (K7c)
gives the FRI oracle F = (S - S(zeta)) / (x - zeta) + alpha^n (S - S(zeta
g)) / (x - zeta g), S = sum_j alpha^j f_j, on a coset block of every
committed LDE batch.  Both launch `csrc/combine.cu` and take CUDA tensors
only; the prover (`prove._openings`, `prove._fri_oracle`) runs their plain
versions, `prove._openings_plain` and `prove._fri_oracle_plain`, for a CPU
tensor.  Each sum mod p is unique, so both give the same canonical residues.

The grids come from the shapes (`openings_geometry`, `oracle_geometry`):
K7r takes tiles of up to MAX_TILE coefficients and as many rows a block as
still fill the card once (three blocks an SM are resident); K7c one thread
a coset point, its rows split over slices where the points give fewer than
two blocks an SM (at 2^17 points, 512 blocks, one slice measured faster
than two).

`emulate_openings` and `emulate_oracle` run the kernels' schedules in plain
torch: the ladder z^(2^j), each block's z^t0 and each thread's z^(t0 + l)
stepped by z^256, the 128-bit products summed exactly in eight 32-bit words
(`acc_mul`) and reduced once a thread (`acc_value`), the lanes' xor
shuffles, the tiles' and slices' partial sums, the coset points from the
ladder omega^(2^j).  The CPU tests hold them against the plain versions, so
they check the schedule that the card runs.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import kernels
from ..field import goldilocks as gl
from ..field import inv_cuda
from ..field.extension import Ext
from ..interop import tensor_from_u64

THREADS = 256  # csrc/combine.cu's geometry (`p2_combine_threads`)
WARP = 32
STEP_LOG = 8  # log2(THREADS): a thread steps its powers by z^THREADS
MAX_TILE = 2048  # coefficients a K7r block (`p2_combine_max_tile`)
MAX_BATCHES = 4  # LDE batches a K7c launch (`p2_combine_max_batches`)
LADDER = 32  # omega^(2^j), j < LADDER, for the coset points
ROW_CHOICES = (256, 128, 64, 32, 16, 8)  # K7r rows a block, most first
OPENINGS_BLOCKS_PER_SM = 3  # resident: 64 KB of powers and 80 registers a thread
ORACLE_BLOCKS_PER_SM = 2
ORACLE_MIN_ROWS = 64  # rows of a K7c slice at least
H100_SMS = 132  # the emulation's default card
_M32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def openings_geometry(k: int, n: int, sms: int) -> tuple:
    """(tile, rows) of K7r on [k, n]: tiles of up to MAX_TILE coefficients
    (a multiple of THREADS), and the most rows a block that still gives
    OPENINGS_BLOCKS_PER_SM blocks an SM (the fewest, 8, otherwise): the
    tile's powers serve every row of its block."""
    tile = min(MAX_TILE, -(-max(n, 1) // THREADS) * THREADS)
    tiles = -(-n // tile)
    for rows in ROW_CHOICES:
        if tiles * -(-k // rows) >= OPENINGS_BLOCKS_PER_SM * sms:
            return tile, rows
    return tile, ROW_CHOICES[-1]


def oracle_geometry(n_polys: int, n: int, sms: int) -> tuple:
    """(slices, rows a slice) of K7c on n_polys rows at n points: one slice,
    unless the points' blocks number fewer than ORACLE_BLOCKS_PER_SM an SM;
    then as many slices as make them up, each of ORACLE_MIN_ROWS rows at
    least."""
    blocks = -(-n // THREADS)
    ny = max(1, min(-(-ORACLE_BLOCKS_PER_SM * sms // blocks), n_polys // ORACLE_MIN_ROWS))
    per = -(-n_polys // ny) if n_polys else 1
    return (-(-n_polys // per) if n_polys else 1), per


def _words(values, device) -> torch.Tensor:
    """[2 len(values)] int64: (c0, c1) of each extension value, a host
    `GLExt` or an `Ext` of 0-d tensors, on `device`."""
    flat = [c for v in values for c in (v.c0, v.c1)]
    if not any(isinstance(c, torch.Tensor) for c in flat):
        return tensor_from_u64(np.array([int(c) % (1 << 64) for c in flat], dtype=np.uint64),
                               device)
    return torch.stack([
        c.reshape(()).to(device=device, dtype=torch.int64) if isinstance(c, torch.Tensor)
        else torch.full((), gl.i64(int(c)), dtype=torch.int64, device=device)
        for c in flat])


def _ladder_ints(n_all: int) -> list:
    """omega^(2^j) for j < LADDER, omega of order n_all (a power of two)."""
    w = gl.primitive_root_of_unity(n_all.bit_length() - 1)
    return [pow(w, 1 << j, gl.P) for j in range(LADDER)]


@functools.lru_cache(maxsize=None)
def _ladder_host(n_all: int):
    return (ctypes.c_uint64 * LADDER)(*_ladder_ints(n_all))


# ---------------------------------------------------------------------------
# The kernel's wrappers
# ---------------------------------------------------------------------------


def openings(coeffs: torch.Tensor, points, offsets=None) -> torch.Tensor:
    """[2, 2, k]: (c0, c1) of sum_t coeffs[i, t] z^t (times its offset)
    for each of the two `points`, one K7r launch (and a small one adding
    the tiles) reading each coefficient once; `points` and `offsets` host
    `GLExt`s or `Ext`s of 0-d tensors, `offsets` None for 1."""
    kernels.require_cuda_int64(coeffs, "openings: coeffs", ndim=2)
    k, n = coeffs.shape
    if len(points) != 2 or (offsets is not None and len(offsets) != 2):
        raise ValueError(f"openings: {len(points)} points and "
                         f"{offsets and len(offsets)} offsets, not 2")
    dev = coeffs.device
    if k == 0 or n == 0:
        return torch.zeros((2, 2, k), dtype=torch.int64, device=dev)
    pts = _words(points, dev)
    offs = None if offsets is None else _words(offsets, dev)
    tile, rows = openings_geometry(k, n, sm_count(dev))
    tiles = -(-n // tile)
    out = torch.empty((2, 2, k), dtype=torch.int64, device=dev)
    partial = torch.empty(tiles * 4 * k, dtype=torch.int64, device=dev) if tiles > 1 else out
    lib = kernels.library()
    kernels.check(lib.p2_combine_openings(
        coeffs.data_ptr(), k, n, pts.data_ptr(), None if offs is None else offs.data_ptr(),
        tile, rows, partial.data_ptr(), out.data_ptr(), kernels.stream_of(coeffs)),
        "combine_openings")
    kernels.count_launch("K7", ("openings", k, n))
    return out


def oracle(lde_batches, alpha_pows: torch.Tensor, scalars, x_base: int = 0,
           n_all: int = None) -> torch.Tensor:
    """[2, N]: F at the coset points x_base .. x_base + N - 1 of a coset of
    n_all (default N) points, from the [k_b, N] LDE batches in order and
    alpha_pows [sum k_b, 2] (a tensor); `scalars` = (zeta, zeta g, S(zeta),
    S(zeta g), alpha^n) as host `GLExt`s or `Ext`s of 0-d tensors.  The
    norms of x - zeta and x - zeta g (one launch), their inverses (two K6
    launches), then one K7c launch (and a small one adding the slices)."""
    dev = lde_batches[0].device
    N = lde_batches[0].shape[-1]
    if not 1 <= len(lde_batches) <= MAX_BATCHES:
        raise ValueError(f"oracle: {len(lde_batches)} batches, at most {MAX_BATCHES}")
    for i, b in enumerate(lde_batches):
        kernels.require_cuda_int64(b, f"oracle: batch {i}", ndim=2)
        if b.device != dev or b.shape[-1] != N:
            raise ValueError(f"oracle: batch {i} is {tuple(b.shape)} on {b.device}, not "
                             f"[*, {N}] on {dev}")
    rows = [b.shape[0] for b in lde_batches]
    n_polys = sum(rows)
    kernels.require_cuda_int64(alpha_pows, "oracle: alpha_pows", ndim=2)
    if tuple(alpha_pows.shape) != (n_polys, 2) or alpha_pows.device != dev:
        raise ValueError(f"oracle: alpha_pows is {tuple(alpha_pows.shape)} on "
                         f"{alpha_pows.device}, not [{n_polys}, 2] on {dev}")
    n_all = N if n_all is None else n_all
    out = torch.empty((2, N), dtype=torch.int64, device=dev)
    if N == 0:
        return out
    scal = _words(scalars, dev)
    ladder = ctypes.addressof(_ladder_host(n_all))
    lib = kernels.library()
    stream = kernels.stream_of(lde_batches[0])
    norms = torch.empty((2, N), dtype=torch.int64, device=dev)
    kernels.check(lib.p2_combine_norms(N, scal.data_ptr(), ladder, x_base, norms.data_ptr(),
                                       stream), "combine_norms")
    ninv0, ninv1 = inv_cuda.batch_inv(norms[0]), inv_cuda.batch_inv(norms[1])
    ny, per = oracle_geometry(n_polys, N, sm_count(dev))
    partial = torch.empty((ny, 2, N), dtype=torch.int64, device=dev) if ny > 1 else out
    ptrs = (ctypes.c_void_p * len(rows))(*[b.data_ptr() for b in lde_batches])
    counts = (ctypes.c_int64 * len(rows))(*rows)
    kernels.check(lib.p2_combine_oracle(
        ctypes.addressof(ptrs), ctypes.addressof(counts), len(rows), N, alpha_pows.data_ptr(),
        n_polys, ny, per, scal.data_ptr(), ninv0.data_ptr(), ninv1.data_ptr(), ladder, x_base,
        partial.data_ptr(), out.data_ptr(), stream), "combine_oracle")
    kernels.count_launch("K7", ("oracle", N, *rows))
    return out


# ---------------------------------------------------------------------------
# The kernel's schedule in plain torch (CPU tests)
# ---------------------------------------------------------------------------


def _canon(x: torch.Tensor) -> torch.Tensor:
    return torch.where(gl._ge_p(x), x - gl._P, x)


def _mad(word, a, b, hi: bool, carry):
    """(word + the low or high half of a * b + carry) as (32-bit word,
    carry): one `mad.lo.cc` / `madc.hi.cc`; a, b < 2^32, so the int64
    product wraps to the exact 64-bit product."""
    p = a * b
    s = word + (((p >> 32) & _M32) if hi else (p & _M32)) + carry
    return s & _M32, s >> 32


def acc_zero(shape) -> list:
    """The accumulator d0..d4, x0..x2 (32-bit words) at 0."""
    return [torch.zeros(shape, dtype=torch.int64) for _ in range(8)]


def acc_mul(acc: list, c: torch.Tensor, w: torch.Tensor) -> list:
    """acc + c * w as the kernel's `acc_mul`: c0 w0 + 2^64 c1 w1 into d in
    one carry chain, c0 w1 and c1 w0 into x."""
    d0, d1, d2, d3, d4, x0, x1, x2 = acc
    c0, c1 = c & _M32, (c >> 32) & _M32
    w0, w1 = w & _M32, (w >> 32) & _M32
    d0, cy = _mad(d0, c0, w0, False, 0)
    d1, cy = _mad(d1, c0, w0, True, cy)
    d2, cy = _mad(d2, c1, w1, False, cy)
    d3, cy = _mad(d3, c1, w1, True, cy)
    d4 = (d4 + cy) & _M32
    x0, cy = _mad(x0, c0, w1, False, 0)
    x1, cy = _mad(x1, c0, w1, True, cy)
    x2 = (x2 + cy) & _M32
    x0, cy = _mad(x0, c1, w0, False, 0)
    x1, cy = _mad(x1, c1, w0, True, cy)
    x2 = (x2 + cy) & _M32
    return [d0, d1, d2, d3, d4, x0, x1, x2]


def acc_value(acc: list) -> torch.Tensor:
    """The accumulator mod p, canonical, as the kernel's `acc_value`:
    reduce128(d3d2, d1d0) - 2^32 d4 + reduce128(x1, 2^32 x0) - x2."""
    d0, d1, d2, d3, d4, x0, x1, x2 = acc
    d = gl.sub(gl._reduce128((d3 << 32) | d2, (d1 << 32) | d0), d4 << 32)
    x = gl.sub(gl._reduce128(x1, x0 << 32), x2)
    return gl.add(d, x)


def _warp_sum(v: torch.Tensor) -> torch.Tensor:
    """The lanes' xor-shuffle tree over the last axis (32 lanes): every lane
    ends with the sum; lane 0's is returned."""
    lane = torch.arange(WARP)
    d = WARP // 2
    while d:
        v = gl.add(v, v[..., lane ^ d])
        d //= 2
    return v[..., 0]


def _ext_of(words: torch.Tensor, i: int) -> Ext:
    return Ext(_canon(words[2 * i]), _canon(words[2 * i + 1]))


def _ext_select(bit: torch.Tensor, a: Ext, b: Ext) -> Ext:
    return Ext(torch.where(bit, a.c0, b.c0), torch.where(bit, a.c1, b.c1))


def _tile_powers(z: Ext, off: Ext, tiles: int, tile: int) -> Ext:
    """[tiles, tile] powers off z^(t0 + c), t0 = tile * block, as K7r's
    blocks make them: the first lanes' ladder z^(2^j) and off z^t0 by
    squaring, thread l's z^(t0 + l) from the ladder's entries for the bits
    of l, then steps of z^THREADS along the thread's columns."""
    t0 = torch.arange(tiles, dtype=torch.int64) * tile
    lad, zj = [], z
    b = Ext(off.c0.expand(tiles), off.c1.expand(tiles))
    j = 0
    while j <= STEP_LOG or bool(((t0 >> j) != 0).any()):
        if j <= STEP_LOG:
            lad.append(zj)
        b = _ext_select(((t0 >> j) & 1).bool(), b * Ext(zj.c0.expand(tiles), zj.c1.expand(tiles)),
                        b)
        zj = zj * zj
        j += 1
    lanes = torch.arange(THREADS)
    cur = Ext(b.c0[:, None].expand(tiles, THREADS), b.c1[:, None].expand(tiles, THREADS))
    for j in range(STEP_LOG):
        cur = _ext_select(((lanes >> j) & 1).bool(), cur * lad[j], cur)
    cols_c0, cols_c1 = [], []
    for _ in range(-(-tile // THREADS)):
        cols_c0.append(cur.c0)
        cols_c1.append(cur.c1)
        cur = cur * lad[STEP_LOG]
    return Ext(torch.cat(cols_c0, 1)[:, :tile], torch.cat(cols_c1, 1)[:, :tile])


def emulate_openings(coeffs: torch.Tensor, points, offsets=None,
                     sms: int = H100_SMS) -> torch.Tensor:
    """`openings` by K7r's schedule in plain torch: each tile's powers
    (`_tile_powers`), lane l of a row's warp summing the columns l, l + 32,
    ... of the tile exactly (`acc_mul`), each lane's sum reduced once
    (`acc_value`), the xor-shuffle tree, then the tiles' sums in tile order.
    (Which block's warp takes a row changes no sum: the row groups are not
    modelled.)"""
    k, n = coeffs.shape
    P = len(points)
    if k == 0 or n == 0:
        return torch.zeros((P, 2, k), dtype=torch.int64)
    tile, _ = openings_geometry(k, n, sms)
    tiles = -(-n // tile)
    pts = _words(points, "cpu")
    offs = _words(offsets, "cpu") if offsets is not None else None
    c = torch.cat([coeffs, coeffs.new_zeros(k, tiles * tile - n)], 1)
    c = c.reshape(k, tiles, tile // WARP, WARP)  # column l + 32 i of a tile: [.., i, l]
    weights = []
    for p in range(P):
        off = _ext_of(offs, p) if offs is not None else Ext(torch.tensor(1), torch.tensor(0))
        pw = _tile_powers(_ext_of(pts, p), off, tiles, tile)
        weights += [w.reshape(tiles, tile // WARP, WARP) for w in pw]
    sums = []
    for w in weights:
        acc = acc_zero((k, tiles, WARP))
        for i in range(tile // WARP):
            acc = acc_mul(acc, c[:, :, i], w[:, i])
        sums.append(_warp_sum(acc_value(acc)))  # [k, tiles]
    partial = torch.stack(sums).permute(2, 0, 1)  # [tiles, 2P, k]
    if tiles == 1:
        return partial[0].reshape(P, 2, k)
    total = torch.zeros((2 * P, k), dtype=torch.int64)
    for t in range(tiles):
        total = gl.add(total, partial[t])
    return total.reshape(P, 2, k)


def _coset_points(n: int, x_base: int, n_all: int) -> torch.Tensor:
    """7 omega^i for i = x_base .. x_base + n - 1 from the ladder, as the
    kernel's `coset_point`."""
    i = torch.arange(n, dtype=torch.int64) + x_base
    x = torch.full((n,), gl.MULTIPLICATIVE_GROUP_GENERATOR, dtype=torch.int64)
    for j, w in enumerate(_ladder_ints(n_all)):
        x = torch.where(((i >> j) & 1).bool(), gl.mul(x, gl.i64(w)), x)
    return x


def emulate_oracle(lde_batches, alpha_pows: torch.Tensor, scalars, x_base: int = 0,
                   n_all: int = None, sms: int = H100_SMS) -> torch.Tensor:
    """`oracle` by K7c's schedule in plain torch: the norms' kernel, their
    inverses (K6's plain version), each slice's rows summed exactly at every
    point and reduced once, the slices added in order, then F."""
    rows = torch.cat(list(lde_batches))
    n_polys, N = rows.shape
    n_all = N if n_all is None else n_all
    scal = _words(scalars, "cpu")
    zeta, zeta_g, s_zeta, s_zeta_g, alpha_n = (_ext_of(scal, i) for i in range(5))
    xs = _coset_points(N, x_base, n_all)
    ninv = [gl.batch_inv(gl.sub(gl.mul(gl.sub(xs, z.c0), gl.sub(xs, z.c0)),
                                gl.mul(gl.mul(z.c1, z.c1), 7)))
            for z in (zeta, zeta_g)]
    ny, per = oracle_geometry(n_polys, N, sms)
    alpha = alpha_pows.reshape(n_polys, 2)
    s0 = s1 = torch.zeros(N, dtype=torch.int64)
    for y in range(ny):
        a0, a1 = acc_zero(N), acc_zero(N)
        for j in range(y * per, min((y + 1) * per, n_polys)):
            a0 = acc_mul(a0, rows[j], alpha[j, 0])
            a1 = acc_mul(a1, rows[j], alpha[j, 1])
        s0, s1 = gl.add(s0, acc_value(a0)), gl.add(s1, acc_value(a1))
    f = None
    for q, (z, s) in enumerate(((zeta, s_zeta), (zeta_g, s_zeta_g))):
        inv = Ext(gl.mul(gl.sub(xs, z.c0), ninv[q]), gl.mul(z.c1, ninv[q]))
        t = Ext(gl.sub(s0, s.c0), gl.sub(s1, s.c1)) * inv
        f = t if q == 0 else f + t * alpha_n
    return torch.stack([f.c0, f.c1])
