// K7: the prover's extension-weighted sums of base-field values as one
// hand-written CUDA kernel source for Hopper (sm_90a), two entry points over
// one accumulator.
//
// Replaces no pallas_call: the reference computes these sums in XLA
// (plonky2_bn254_tpu/prover/prove.py, the openings and the FRI oracle).  The
// port's plain versions (plonky2_bn254_tpu_torch/prover/prove.py
// `_openings_plain`, `_fri_oracle_plain`) build them from int64 tensor
// operations: a power table z^0 .. z^(n-1) by doubling, then a full
// Goldilocks product over the whole [k, n] batch for each of a weight's two
// coordinates, each followed by a log-depth tree of adds: ~8,000 elementwise
// kernels and ~2.5 tensor widths of device memory a pass for one opening.
//
//   K7r (openings): f_i(z_p) = sum_t c_(i,t) z_p^t for every row i of a [k, n]
//       coefficient batch at two points z_p at once (zeta and zeta * g),
//       each times an optional offset (a mesh rank's z^(r n/D)).
//   K7c (FRI oracle): S(x) = sum_j alpha^j f_j(x) over the rows of every
//       committed LDE batch at once, at every coset point x, and the
//       quotients F = (S - S(zeta)) / (x - zeta) + alpha^n (S - S(zeta g)) /
//       (x - zeta g) in the same pass; the denominators' norms come from a
//       small kernel here and are inverted by K6 (csrc/inverse.cu).
//
// Bound on the H100: bytes.  Each base value is read once (8 bytes) and
// weighted by four (K7r) or two (K7c) extension coordinates; a product kept as 128 bits
// costs ~10 int32 instructions (the reduction is deferred to one per
// thread's sum), ~40 an opening's coefficient and ~20 an oracle's value,
// below the card's balance of ~80 instructions per 8 bytes.
//
// Design.  Every product c * w of two 64-bit words is added exactly into an
// accumulator of eight 32-bit words (`Acc`): d = sum c0 w0 + 2^64 c1 w1 in
// five words and x = sum (c0 w1 + c1 w0) in three, the sum being d + 2^32 x,
// so a product is 11 multiply-adds with carry and no reduction.  A thread's
// sum is reduced mod p once (`acc_value`); thread sums are then added mod p.
//
//   K7r: a block takes a tile of TILE consecutive coefficients of a group of
//   rows.  Its first lanes build the ladder z^(2^j) (j <= 8) and z^t0 times
//   the offset by squaring, each thread l forms z^(t0 + l) from the ladder's
//   entries for the bits of l, then steps by z^256 along its columns, so the
//   tile's powers of both points sit in shared memory: no power table in
//   device memory, and each power serves every row of the group.  A warp
//   takes a row at a time; its lanes read consecutive coefficients (256
//   bytes a warp access) and each coefficient is read once for both points.
//   The lanes' sums are added by xor shuffles; a tile's sums go to a
//   [tiles, 4, k] array that a second small launch adds up.
//   K7c: one thread a coset point, so a row of the [k, N] LDE is read in
//   256-byte warp accesses; alpha^j and each row's address are staged in
//   shared memory a chunk at a time (a broadcast read).  Where the points
//   give too few blocks to fill the card, the rows split over blockIdx.y
//   and a second small launch adds the slices and applies the quotients.
//
// The grids come from the shapes (the wrapper, prover/combine_cuda.py).
// Every sum mod p is unique and every output canonical, so the outputs equal
// the plain versions' bit for bit, for any 64-bit inputs.
#include <cstdint>

#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int THREADS = 256;  // a block; z^THREADS is the power step
constexpr int STEP_LOG = 8;   // log2(THREADS)
constexpr int WARPS = THREADS / 32;
constexpr int MAX_TILE = 2048;       // coefficients a K7r block
constexpr int POINTS = 2;  // K7r's points, zeta and zeta g
constexpr int STREAMS = 2 * POINTS;  // a coordinate of a point's power each
constexpr int ORACLE_CHUNK = 512;    // rows of alpha^j staged at a time
constexpr int MAX_BATCHES = 4;       // LDE batches a K7c launch
constexpr int LADDER = 32;           // omega^(2^j) for the coset points
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Ext {
  uint64_t c0, c1;
};

__device__ __forceinline__ uint64_t canon(uint64_t x) { return x >= gl::P ? x - gl::P : x; }

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }

// (a0 + a1 X)(b0 + b1 X) with X^2 = 7
__device__ __forceinline__ Ext ext_mul(Ext a, Ext b) {
  const uint64_t a0b0 = gl::mul(a.c0, b.c0), a1b1 = gl::mul(a.c1, b.c1);
  const uint64_t a0b1 = gl::mul(a.c0, b.c1), a1b0 = gl::mul(a.c1, b.c0);
  return {gl::add(a0b0, gl::mul(a1b1, 7)), gl::add(a0b1, a1b0)};
}

// An exact sum of 128-bit products: d = d4..d0 (160 bits), x = x2..x0 (96
// bits), the value d + 2^32 x.
struct Acc {
  uint32_t d0, d1, d2, d3, d4, x0, x1, x2;
};

// acc += c * w: c0 w0 + 2^64 c1 w1 into d in one carry chain, the two cross
// products c0 w1 and c1 w0 into x.
__device__ __forceinline__ void acc_mul(Acc& a, uint64_t c, uint64_t w) {
  asm("{\n\t"
      ".reg .u32 c0, c1, w0, w1;\n\t"
      "mov.b64 {c0, c1}, %8;\n\t"
      "mov.b64 {w0, w1}, %9;\n\t"
      "mad.lo.cc.u32 %0, c0, w0, %0;\n\t"
      "madc.hi.cc.u32 %1, c0, w0, %1;\n\t"
      "madc.lo.cc.u32 %2, c1, w1, %2;\n\t"
      "madc.hi.cc.u32 %3, c1, w1, %3;\n\t"
      "addc.u32 %4, %4, 0;\n\t"
      "mad.lo.cc.u32 %5, c0, w1, %5;\n\t"
      "madc.hi.cc.u32 %6, c0, w1, %6;\n\t"
      "addc.u32 %7, %7, 0;\n\t"
      "mad.lo.cc.u32 %5, c1, w0, %5;\n\t"
      "madc.hi.cc.u32 %6, c1, w0, %6;\n\t"
      "addc.u32 %7, %7, 0;\n\t"
      "}"
      : "+r"(a.d0), "+r"(a.d1), "+r"(a.d2), "+r"(a.d3), "+r"(a.d4), "+r"(a.x0), "+r"(a.x1),
        "+r"(a.x2)
      : "l"(c), "l"(w));
}

// The accumulator mod p, canonical: 2^128 = -2^32 and 2^96 = -1 (mod p), so
// d = reduce128(d3d2, d1d0) - 2^32 d4 and 2^32 x = reduce128(x1, x0 2^32) - x2.
__device__ __forceinline__ uint64_t acc_value(const Acc& a) {
  const uint64_t lo = ((uint64_t)a.d1 << 32) | a.d0;
  const uint64_t hi = ((uint64_t)a.d3 << 32) | a.d2;
  const uint64_t d = gl::sub(gl::reduce128(hi, lo), (uint64_t)a.d4 << 32);
  const uint64_t x = gl::sub(gl::reduce128(a.x1, (uint64_t)a.x0 << 32), a.x2);
  return gl::add(d, x);
}

__device__ __forceinline__ uint64_t warp_sum(uint64_t v) {
#pragma unroll
  for (int d = 16; d; d >>= 1) v = gl::add(v, __shfl_xor_sync(FULL, v, d));
  return v;
}

// ---------------------------------------------------------------------------
// K7r: the openings
// ---------------------------------------------------------------------------

// Block (tile, group): columns [t0, t0 + tile) of rows [row0, row0 + rows);
// partial[(tile * 4 + s) * k + r] = sum over the tile of c_(r,t) times
// coordinate s % 2 of z_(s/2)^t (times the offset).  `pts`: the two points
// (c0, c1); `offs`: their offsets or null (1).
__global__ void __launch_bounds__(THREADS, 3)
openings_kernel(const uint64_t* __restrict__ coeffs, int64_t k, int64_t n,
                const uint64_t* __restrict__ pts, const uint64_t* __restrict__ offs, int tile,
                int rows, uint64_t* __restrict__ partial) {
  extern __shared__ uint64_t pw[];  // [STREAMS][tile]: coordinate s of the tile's powers
  __shared__ Ext lad[POINTS][STEP_LOG + 1];
  __shared__ Ext base[POINTS];
  const int64_t t0 = (int64_t)blockIdx.x * tile;
  if (threadIdx.x < POINTS) {  // z^(2^j) for j <= 8, and offset * z^t0, by squaring
    const int p = threadIdx.x;
    Ext z = {canon(pts[2 * p]), canon(pts[2 * p + 1])};
    Ext b = offs ? Ext{canon(offs[2 * p]), canon(offs[2 * p + 1])} : Ext{1, 0};
    for (int j = 0; j <= STEP_LOG || (t0 >> j) != 0; ++j) {
      if (j <= STEP_LOG) lad[p][j] = z;
      if ((t0 >> j) & 1) b = ext_mul(b, z);
      if (j < STEP_LOG || (t0 >> (j + 1)) != 0) z = ext_mul(z, z);
    }
    base[p] = b;
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < POINTS; ++p) {  // column c = l + 256 m: z^(t0 + l) z^(256 m)
    Ext cur = base[p];
#pragma unroll
    for (int j = 0; j < STEP_LOG; ++j)
      if ((threadIdx.x >> j) & 1) cur = ext_mul(cur, lad[p][j]);
    for (int c = threadIdx.x; c < tile; c += THREADS) {
      pw[(2 * p) * tile + c] = cur.c0;
      pw[(2 * p + 1) * tile + c] = cur.c1;
      if (c + THREADS < tile) cur = ext_mul(cur, lad[p][STEP_LOG]);
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cols = (int)lmin(tile, n - t0);
  const int64_t row0 = (int64_t)blockIdx.y * rows;
  const int64_t row_end = lmin(row0 + rows, k);
  for (int64_t r = row0 + warp; r < row_end; r += WARPS) {
    const uint64_t* src = coeffs + r * n + t0;
    Acc acc[STREAMS] = {};
#pragma unroll 4
    for (int c = lane; c < cols; c += 32) {
      const uint64_t v = src[c];
#pragma unroll
      for (int s = 0; s < STREAMS; ++s) acc_mul(acc[s], v, pw[s * tile + c]);
    }
#pragma unroll
    for (int s = 0; s < STREAMS; ++s) {
      const uint64_t sum = warp_sum(acc_value(acc[s]));
      if (lane == 0) partial[((int64_t)blockIdx.x * STREAMS + s) * k + r] = sum;
    }
  }
}

// out[i] = sum over the tiles of partial[tile * m + i], i < m = 4 k.
__global__ void __launch_bounds__(THREADS)
openings_finish_kernel(const uint64_t* __restrict__ partial, int64_t tiles, int64_t m,
                       uint64_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= m) return;
  uint64_t s = 0;
  for (int64_t t = 0; t < tiles; ++t) s = gl::add(s, partial[t * m + i]);
  out[i] = s;
}

// ---------------------------------------------------------------------------
// K7c: the FRI oracle's combination
// ---------------------------------------------------------------------------

struct Batches {
  const uint64_t* ptr[MAX_BATCHES];
  int64_t rows[MAX_BATCHES];
  int count;
};

struct Ladder {  // w[j] = omega^(2^j), omega of order the whole coset's size
  uint64_t w[LADDER];
};

// The coset point 7 omega^i.
__device__ __forceinline__ uint64_t coset_point(const Ladder& lad, int64_t i) {
  uint64_t x = 7;  // the multiplicative group's generator, the coset shift
#pragma unroll
  for (int j = 0; j < LADDER; ++j)
    if ((i >> j) & 1) x = gl::mul(x, lad.w[j]);
  return x;
}

// F at point x from S(x): `scal` holds (zeta, zeta g, S(zeta), S(zeta g),
// alpha^n) as (c0, c1) pairs; ninv_q = 1 / norm(x - point q).
__device__ __forceinline__ void oracle_epilogue(uint64_t s0, uint64_t s1, int64_t x, int64_t n,
                                                const uint64_t* __restrict__ scal,
                                                const uint64_t* __restrict__ ninv0,
                                                const uint64_t* __restrict__ ninv1,
                                                const Ladder& lad, int64_t x_base,
                                                uint64_t* __restrict__ out) {
  const uint64_t xv = coset_point(lad, x_base + x);
  Ext f = {0, 0};
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const uint64_t ni = (q ? ninv1 : ninv0)[x];
    const Ext inv = {gl::mul(gl::sub(xv, canon(scal[2 * q])), ni),
                     gl::mul(canon(scal[2 * q + 1]), ni)};
    const Ext num = {gl::sub(s0, canon(scal[4 + 2 * q])), gl::sub(s1, canon(scal[5 + 2 * q]))};
    Ext t = ext_mul(num, inv);
    if (q) t = ext_mul(t, {canon(scal[8]), canon(scal[9])});
    f = {gl::add(f.c0, t.c0), gl::add(f.c1, t.c1)};
  }
  out[x] = f.c0;
  out[n + x] = f.c1;
}

// norm[q][x] = (x - z_q.c0)^2 - 7 z_q.c1^2 for the points zeta, zeta g.
__global__ void __launch_bounds__(THREADS)
norms_kernel(int64_t n, const uint64_t* __restrict__ scal, Ladder lad, int64_t x_base,
             uint64_t* __restrict__ out) {
  const int64_t x = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (x >= n) return;
  const uint64_t xv = coset_point(lad, x_base + x);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const uint64_t d0 = gl::sub(xv, canon(scal[2 * q]));
    const uint64_t c1 = canon(scal[2 * q + 1]);
    out[q * n + x] = gl::sub(gl::mul(d0, d0), gl::mul(gl::mul(c1, c1), 7));
  }
}

// Rows [y rows_per_y, (y + 1) rows_per_y) of the batches (in order) at
// point x: fused, F at x into out[2][n]; else S's slice into
// partial[(y * 2 + c) * n + x].
__global__ void __launch_bounds__(THREADS)
oracle_kernel(Batches b, int64_t n, const uint64_t* __restrict__ alpha, int64_t n_polys,
              int64_t rows_per_y, const uint64_t* __restrict__ scal,
              const uint64_t* __restrict__ ninv0, const uint64_t* __restrict__ ninv1, Ladder lad,
              int64_t x_base, uint64_t* __restrict__ out, int fused) {
  __shared__ uint64_t a0s[ORACLE_CHUNK], a1s[ORACLE_CHUNK];
  __shared__ const uint64_t* rowp[ORACLE_CHUNK];
  const int64_t x = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t j0 = (int64_t)blockIdx.y * rows_per_y;
  const int64_t j1 = lmin(j0 + rows_per_y, n_polys);
  Acc s0 = {}, s1 = {};
  for (int64_t c0 = j0; c0 < j1; c0 += ORACLE_CHUNK) {
    const int m = (int)lmin(ORACLE_CHUNK, j1 - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += THREADS) {
      const int64_t j = c0 + i;
      a0s[i] = alpha[2 * j];
      a1s[i] = alpha[2 * j + 1];
      int64_t r = j;
      const uint64_t* row = nullptr;
#pragma unroll
      for (int q = 0; q < MAX_BATCHES; ++q) {
        if (row == nullptr && q < b.count) {
          if (r < b.rows[q]) row = b.ptr[q] + r * n;
          else r -= b.rows[q];
        }
      }
      rowp[i] = row;
    }
    __syncthreads();
    if (x < n) {
#pragma unroll 8
      for (int i = 0; i < m; ++i) {
        const uint64_t v = rowp[i][x];
        acc_mul(s0, v, a0s[i]);
        acc_mul(s1, v, a1s[i]);
      }
    }
  }
  if (x >= n) return;
  const uint64_t v0 = acc_value(s0), v1 = acc_value(s1);
  if (fused) {
    oracle_epilogue(v0, v1, x, n, scal, ninv0, ninv1, lad, x_base, out);
  } else {
    out[((int64_t)blockIdx.y * 2) * n + x] = v0;
    out[((int64_t)blockIdx.y * 2 + 1) * n + x] = v1;
  }
}

// S = the sum of the ny slices, then F as in the fused kernel.
__global__ void __launch_bounds__(THREADS)
oracle_finish_kernel(const uint64_t* __restrict__ partial, int ny, int64_t n,
                     const uint64_t* __restrict__ scal, const uint64_t* __restrict__ ninv0,
                     const uint64_t* __restrict__ ninv1, Ladder lad, int64_t x_base,
                     uint64_t* __restrict__ out) {
  const int64_t x = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (x >= n) return;
  uint64_t s0 = 0, s1 = 0;
  for (int y = 0; y < ny; ++y) {
    s0 = gl::add(s0, partial[((int64_t)y * 2) * n + x]);
    s1 = gl::add(s1, partial[((int64_t)y * 2 + 1) * n + x]);
  }
  oracle_epilogue(s0, s1, x, n, scal, ninv0, ninv1, lad, x_base, out);
}

Ladder ladder_of(const uint64_t* host) {
  Ladder lad;
  for (int j = 0; j < LADDER; ++j) lad.w[j] = host[j];
  return lad;
}

int64_t blocks_of(int64_t n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

extern "C" {

int64_t p2_combine_threads() { return THREADS; }
int64_t p2_combine_max_tile() { return MAX_TILE; }
int64_t p2_combine_max_batches() { return MAX_BATCHES; }

// K7r.  coeffs [k, n]; pts [2][2], offs [2][2] or null; out [2][2][k]: (c0,
// c1) of sum_t coeffs[i][t] z^t (times the offset) for each point z.
// `partial` holds tiles * 4 k words, unused when n <= tile (one tile writes
// out).
int p2_combine_openings(const void* coeffs, int64_t k, int64_t n, const void* pts,
                        const void* offs, int tile, int rows, void* partial, void* out,
                        void* stream) {
  if (k <= 0 || n <= 0) return 0;
  if (tile <= 0 || tile > MAX_TILE || rows <= 0) return -1;
  const int64_t tiles = (n + tile - 1) / tile;
  const int64_t groups = (k + rows - 1) / rows;
  if (tiles > 0x7FFFFFFF || groups > 65535) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  uint64_t* dst = tiles == 1 ? (uint64_t*)out : (uint64_t*)partial;
  const size_t smem = (size_t)STREAMS * tile * sizeof(uint64_t);
  cudaFuncSetAttribute(openings_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  openings_kernel<<<dim3((unsigned)tiles, (unsigned)groups), THREADS, smem, st>>>(
      (const uint64_t*)coeffs, k, n, (const uint64_t*)pts, (const uint64_t*)offs, tile, rows,
      dst);
  int err = (int)cudaGetLastError();
  if (err || tiles == 1) return err;
  const int64_t m = STREAMS * k;
  openings_finish_kernel<<<(unsigned)blocks_of(m), THREADS, 0, st>>>(
      (const uint64_t*)partial, tiles, m, (uint64_t*)out);
  return (int)cudaGetLastError();
}

// K7c's denominators.  scal: (zeta, zeta g) as (c0, c1) pairs; ladder: 32
// host words omega^(2^j); out [2][n]: the norms of x - zeta and x - zeta g
// at the coset points x_base .. x_base + n - 1.
int p2_combine_norms(int64_t n, const void* scal, const void* ladder, int64_t x_base, void* out,
                     void* stream) {
  if (n <= 0) return 0;
  if (blocks_of(n) > 0x7FFFFFFF) return -1;
  norms_kernel<<<(unsigned)blocks_of(n), THREADS, 0, (cudaStream_t)stream>>>(
      n, (const uint64_t*)scal, ladder_of((const uint64_t*)ladder), x_base, (uint64_t*)out);
  return (int)cudaGetLastError();
}

// K7c.  ptrs, rows: `count` host entries, the LDE batches [rows[i], n] in
// order; alpha [n_polys][2] with n_polys the sum of rows; scal: (zeta, zeta
// g, S(zeta), S(zeta g), alpha^n_polys) as (c0, c1) pairs; ninv0, ninv1 [n];
// out [2][n]: F.  The rows split into ny slices of rows_per_y; with ny > 1,
// `partial` holds ny * 2 * n words.
int p2_combine_oracle(const void* ptrs, const void* rows, int count, int64_t n,
                      const void* alpha, int64_t n_polys, int ny, int64_t rows_per_y,
                      const void* scal, const void* ninv0, const void* ninv1, const void* ladder,
                      int64_t x_base, void* partial, void* out, void* stream) {
  if (n <= 0) return 0;
  if (count < 1 || count > MAX_BATCHES || ny < 1 || ny > 65535 || rows_per_y < 1) return -1;
  if (blocks_of(n) > 0x7FFFFFFF) return -1;
  Batches b = {};
  int64_t total = 0;
  for (int i = 0; i < count; ++i) {
    b.ptr[i] = ((const uint64_t* const*)ptrs)[i];
    b.rows[i] = ((const int64_t*)rows)[i];
    total += b.rows[i];
  }
  b.count = count;
  if (total != n_polys || (n_polys > 0 && (int64_t)(ny - 1) * rows_per_y >= n_polys)) return -1;
  const Ladder lad = ladder_of((const uint64_t*)ladder);
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)blocks_of(n), (unsigned)ny);
  oracle_kernel<<<grid, THREADS, 0, st>>>(
      b, n, (const uint64_t*)alpha, n_polys, rows_per_y, (const uint64_t*)scal,
      (const uint64_t*)ninv0, (const uint64_t*)ninv1, lad, x_base,
      ny == 1 ? (uint64_t*)out : (uint64_t*)partial, ny == 1);
  int err = (int)cudaGetLastError();
  if (err || ny == 1) return err;
  oracle_finish_kernel<<<(unsigned)blocks_of(n), THREADS, 0, st>>>(
      (const uint64_t*)partial, ny, n, (const uint64_t*)scal, (const uint64_t*)ninv0,
      (const uint64_t*)ninv1, lad, x_base, (uint64_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
