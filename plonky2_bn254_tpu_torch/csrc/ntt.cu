// Batched Goldilocks NTT / iNTT / coset LDE as hand-written CUDA kernels for
// Hopper (sm_90a).  Natural order in and out along the last axis of [w, n].
//
// K3 (p2_ntt_rows, or p2_ntt_columns then p2_ntt_rows_t) replaces
//    plonky2_bn254_tpu/field/ntt_pallas.py _dft_sublane_fn (bodies
//    _make_dft_kernel, _run_stages): the four-step NTT/iNTT driven by
//    _ntt_fn.
// K4 (the same kernels with a premultiply table) replaces ntt_pallas.py
//    _lde_stage_a_fn: the rate-1 coset LDE (premultiply by shift^i,
//    zero-extend, forward NTT on shift * H), here for any rate.
//
// Bound on the H100: integer operations.  A radix-2 butterfly is one
// Goldilocks product, one addition and one subtraction (~45 int32 ops) per
// 16 bytes, and a transform of 2^16 words does 16 butterflies per pair of
// words: ~360 ops per word against 16 bytes read and written, far above the
// card's balance, so long as the batch leaves shared memory only twice.
//
// Design: a two-pass four-step.  n = n1 * n2, word i = i1 * n2 + i2.
//   Pass 1 (ntt_columns_kernel): a block takes an [n1, L] slab of L
//     contiguous columns of one row (L * 8 bytes per row segment, coalesced),
//     runs the n1-point transforms down the columns in shared memory and
//     multiplies by the four-step twiddle T[k1, i2] = w_n^(k1 * i2) (times
//     n^-1 for the inverse) on the way out, into a scratch batch.  For the
//     LDE it premultiplies by shift^i on the way in, never reads the
//     zero-extended part, and does the first DIF stage (a, 0) -> (a, a w^i)
//     as it fills the tile.
//   Pass 2 (ntt_rows_t_kernel): a block takes L rows k1 of that scratch
//     (contiguous) and runs the n2-point transforms along them; output k2 of
//     row k1 is word k1 + n1 * k2, so L rows give runs of L consecutive
//     words, coalesced too.
// A row of n <= 2^10 is one pass (ntt_rows_kernel), many rows per block.
// Inside a tile the transform is radix-2 DIF, natural order in: each thread
// holds 16 words (a radix-16 group, 4 stages) in registers between shared
// memory exchanges.  The last group's outputs go to their bit-reversed
// places: in the two-pass kernels straight from registers to device memory
// (16 threads of consecutive lines store 16 consecutive words), in the
// one-pass kernel back into the tile, which is then written out row by row;
// no global access is a gather.  Trivial twiddles of the last group are
// skipped.  A thread issues all its loads of a tile from device memory
// before it uses any, so a tile waits on one memory round trip.  Tiles are
// L lines of M words: in pass 1 a line is a column (word (u, i) at
// u + i * L), elsewhere a row padded to M + 1 words; with the thread's line
// index fastest, every 16-thread half-warp touches 16 distinct 8-byte bank
// pairs in both layouts.  Twiddles w_M^k (k < M/2) sit in shared memory.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int RADIX_LOG = 4;  // 16 words a thread between shared exchanges
constexpr int PER_THREAD = 1 << RADIX_LOG;  // most words a thread moves a tile
constexpr int MAX_THREADS = 512;
constexpr int MIN_BLOCKS = 2;  // 64 registers a thread: 4 blocks of 256 an SM
constexpr int MAX_SHARED = 100 * 1024;  // bytes of dynamic shared memory

__device__ __forceinline__ int bit_rev(int i, int bits) {
  return bits == 0 ? 0 : (int)(__brev((unsigned)i) >> (32 - bits));
}

// Where the last pass puts output word i of line u.  ToTile: back into the
// tile, at its natural-order place (in place, so only once every word of
// the tile is in registers).  The two-pass kernels store straight to device
// memory instead (ColumnsOut, RowsOut): the line index is the thread's
// fastest, so 16 threads store 16 consecutive words.
struct ToTile {
  static constexpr bool in_place = true;
  uint64_t* sh;
  int ls, es;
  __device__ __forceinline__ void operator()(int u, int i, uint64_t v) const {
    sh[u * ls + i * es] = v;
  }
};

// One pass of R = 2^R_LOG radix-2 DIF stages j = lo + R_LOG - 1 ... lo over
// every line of the tile, each thread taking groups of R words whose indices
// differ only in bits [lo, lo + R_LOG).  The last pass (lo = 0) has exactly
// one group per thread and hands its outputs to `out` in natural order.
template <int R_LOG, bool LAST, class Out>
__device__ __forceinline__ void dif_pass(uint64_t* sh, const uint64_t* tw,
                                         int m, int lo, int log_l, int ls,
                                         int es, const Out& out) {
  constexpr int R = 1 << R_LOG;
  const int L = 1 << log_l;
  const int groups = L << (m - R_LOG);
  const int step = es << lo;
  for (int gi = threadIdx.x; gi < groups; gi += blockDim.x) {
    const int u = gi & (L - 1);
    const int g = gi >> log_l;
    const int b_lo = g & ((1 << lo) - 1);
    const int base = b_lo | ((g >> lo) << (lo + R_LOG));
    const int a0 = u * ls + base * es;
    uint64_t v[R];
#pragma unroll
    for (int t = 0; t < R; t++) v[t] = sh[a0 + t * step];
#pragma unroll
    for (int jj = R_LOG - 1; jj >= 0; jj--) {
      const int half = 1 << jj;
      const int tw_shift = m - 1 - (lo + jj);
#pragma unroll
      for (int t = 0; t < R; t++) {
        if (t & half) continue;
        const int q = t & (half - 1);
        const uint64_t a = v[t], b = v[t + half];
        v[t] = gl::add(a, b);
        const uint64_t d = gl::sub(a, b);
        if (LAST) {
          v[t + half] = q == 0 ? d : gl::mul(d, tw[q << tw_shift]);
        } else {
          v[t + half] = gl::mul(d, tw[(b_lo + (q << lo)) << tw_shift]);
        }
      }
    }
    if (LAST) {
      if (Out::in_place) __syncthreads();  // every word of the tile is in registers
#pragma unroll
      for (int t = 0; t < R; t++) out(u, bit_rev(base + t, m), v[t]);
    } else {
#pragma unroll
      for (int t = 0; t < R; t++) sh[a0 + t * step] = v[t];
    }
  }
}

template <bool LAST, class Out>
__device__ __forceinline__ void dif_pass_r(int r, uint64_t* sh,
                                           const uint64_t* tw, int m, int lo,
                                           int log_l, int ls, int es,
                                           const Out& out) {
  switch (r) {
    case 1: dif_pass<1, LAST>(sh, tw, m, lo, log_l, ls, es, out); break;
    case 2: dif_pass<2, LAST>(sh, tw, m, lo, log_l, ls, es, out); break;
    case 3: dif_pass<3, LAST>(sh, tw, m, lo, log_l, ls, es, out); break;
    default: dif_pass<4, LAST>(sh, tw, m, lo, log_l, ls, es, out); break;
  }
}

// The 2^m-point transform of every line of the tile (word i of line u at
// u * ls + i * es), natural order in, after the first `top` (0 or 1)
// stages; output word i of line u goes to out(u, i, value).  Passes of 4
// stages from the top, the first taking the remainder; blockDim.x must be
// L * 2^m / 2^r of the last pass, r = min(m - top, 4).
template <class Out>
__device__ void dft_tile(uint64_t* sh, const uint64_t* tw, int m, int log_l,
                         int ls, int es, int top, const Out& out) {
  const int s = m - top;
  // Only the one-pass kernel (in place) has 1-point rows; two-pass tiles
  // have m >= 5 (n > 2^10).
  if (s == 0) return;
  int r = s % RADIX_LOG ? s % RADIX_LOG : RADIX_LOG;
  for (int lo = s - r; lo > 0; lo -= RADIX_LOG, r = RADIX_LOG) {
    dif_pass_r<false>(r, sh, tw, m, lo, log_l, ls, es, out);
    __syncthreads();
  }
  dif_pass_r<true>(r, sh, tw, m, 0, log_l, ls, es, out);
}

// Twiddles w_M^k, k < M/2, into shared memory (one word for M = 1).
__device__ __forceinline__ void load_twiddles(uint64_t* dst,
                                              const uint64_t* __restrict__ tw,
                                              int m) {
  const int count = m == 0 ? 1 : 1 << (m - 1);
  for (int k = threadIdx.x; k < count; k += blockDim.x) dst[k] = tw[k];
}

// Word i of a source row: x[i], or for the LDE x[i] * shift^i below n_src
// and zero above.
__device__ __forceinline__ uint64_t source_word(const uint64_t* __restrict__ row,
                                                const uint64_t* __restrict__ pre,
                                                int i, int n_src) {
  if (pre == nullptr) return row[i];
  return i < n_src ? gl::mul(row[i], pre[i]) : 0ull;
}

// One pass: L whole rows of M = 2^m words per block.
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
ntt_rows_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y,
                const uint64_t* __restrict__ tw,
                const uint64_t* __restrict__ pre, int64_t w, int m,
                int log_src, int log_l, int scale, uint64_t n_inv) {
  extern __shared__ uint64_t smem[];
  const int M = 1 << m, L = 1 << log_l, ls = M + 1;
  uint64_t* tw_sh = smem;
  uint64_t* sh = smem + (m == 0 ? 1 : M / 2);
  const int64_t row0 = (int64_t)blockIdx.x * L;
  const int n_src = 1 << log_src;
  load_twiddles(tw_sh, tw, m);
  for (int e = threadIdx.x; e < L * M; e += blockDim.x) {
    const int u = e >> m, i = e & (M - 1);
    const int64_t row = row0 + u;
    uint64_t v = 0;
    if (row < w) {
      v = source_word(x + row * (pre ? n_src : M), pre, i, n_src);
    }
    sh[u * ls + i] = v;
  }
  __syncthreads();
  dft_tile(sh, tw_sh, m, log_l, ls, 1, 0, ToTile{sh, ls, 1});
  __syncthreads();
  for (int e = threadIdx.x; e < L * M; e += blockDim.x) {
    const int u = e >> m, i = e & (M - 1);
    const int64_t row = row0 + u;
    if (row < w) {
      const uint64_t v = sh[u * ls + i];
      y[row * M + i] = scale ? gl::mul(v, n_inv) : v;
    }
  }
}

// Pass 1's output word k1 of column c0 + u, times the four-step twiddle.
struct ColumnsOut {
  static constexpr bool in_place = false;
  uint64_t* dst;
  const uint64_t* four_step;
  int m2, c0;
  __device__ __forceinline__ void operator()(int u, int k1, uint64_t v) const {
    const int i = (k1 << m2) + c0 + u;
    dst[i] = gl::mul(v, four_step[i]);
  }
};

// Pass 1: an [n1, L] column slab of one row; out[k1 * n2 + i2] =
// T[k1 * n2 + i2] * (n1-point transform of column i2)[k1].
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
ntt_columns_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ out,
                   const uint64_t* __restrict__ tw,
                   const uint64_t* __restrict__ four_step,
                   const uint64_t* __restrict__ pre, int m1, int m2,
                   int log_src, int log_l) {
  extern __shared__ uint64_t smem[];
  const int L = 1 << log_l, M = 1 << m1, n2 = 1 << m2;
  uint64_t* tw_sh = smem;
  uint64_t* sh = smem + M / 2;
  const int slabs = n2 >> log_l;
  const int64_t row = blockIdx.x / slabs;
  const int c0 = (blockIdx.x % slabs) << log_l;
  const int n_src = 1 << log_src;
  const int64_t n = (int64_t)M << m2;
  const uint64_t* src = x + row * (pre ? (int64_t)n_src : n);
  // LDE (n_src < n): the upper half of every column is zero, so the first
  // DIF stage maps (a, 0) to (a, a * w_M^i1), done here on the way in.
  // The coefficients come from device memory, all loads of a thread first;
  // shift^i and the twiddles are tables read where they are used.
  const int top = n_src < n ? 1 : 0;
  const int half = (L * M) >> top;
  uint64_t v[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; k++) {
    const int e = threadIdx.x + k * blockDim.x;
    const int i = ((e >> log_l) << m2) + c0 + (e & (L - 1));
    if (e < half) v[k] = i < n_src ? src[i] : 0ull;
  }
  load_twiddles(tw_sh, tw, m1);
  if (top) __syncthreads();
#pragma unroll
  for (int k = 0; k < PER_THREAD; k++) {
    const int e = threadIdx.x + k * blockDim.x;
    const int i = ((e >> log_l) << m2) + c0 + (e & (L - 1));
    if (e < half) {
      const uint64_t a = pre == nullptr ? v[k] : i < n_src ? gl::mul(v[k], pre[i]) : 0ull;
      sh[e] = a;
      if (top) sh[e + half] = gl::mul(a, tw_sh[e >> log_l]);
    }
  }
  __syncthreads();
  dft_tile(sh, tw_sh, m1, log_l, 1, L, top,
           ColumnsOut{out + row * n, four_step, m2, c0});
}

// Pass 2's output word k2 of row k1_0 + u: word k1 + n1 * k2.
struct RowsOut {
  static constexpr bool in_place = false;
  uint64_t* dst;
  int m1;
  __device__ __forceinline__ void operator()(int u, int k2, uint64_t v) const {
    dst[((int64_t)k2 << m1) + u] = v;
  }
};

// Pass 2: L rows k1 of pass 1's output; y[k1 + n1 * k2] = (n2-point
// transform of row k1)[k2].
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
ntt_rows_t_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y,
                  const uint64_t* __restrict__ tw, int m1, int m2, int log_l) {
  extern __shared__ uint64_t smem[];
  const int L = 1 << log_l, M = 1 << m2, ls = M + 1;
  uint64_t* tw_sh = smem;
  uint64_t* sh = smem + M / 2;
  const int groups = (1 << m1) >> log_l;
  const int64_t row = blockIdx.x / groups;
  const int k1_0 = (blockIdx.x % groups) << log_l;
  const int64_t n = (int64_t)M << m1;
  const uint64_t* src = x + row * n + ((int64_t)k1_0 << m2);
  uint64_t v[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; k++) {
    const int e = threadIdx.x + k * blockDim.x;
    if (e < L * M) v[k] = src[e];
  }
  load_twiddles(tw_sh, tw, m2);
#pragma unroll
  for (int k = 0; k < PER_THREAD; k++) {
    const int e = threadIdx.x + k * blockDim.x;
    if (e < L * M) sh[(e >> m2) * ls + (e & (M - 1))] = v[k];
  }
  __syncthreads();
  dft_tile(sh, tw_sh, m2, log_l, ls, 1, 0,
           RowsOut{y + row * n + k1_0, m1});
}

// Threads of a tile of L lines of 2^m words: one radix group each in the
// last pass.  (Pass 1 skips a stage only for m >= 6, leaving r = 4.)
int tile_threads(int m, int log_l) {
  const int r = m < RADIX_LOG ? m : RADIX_LOG;
  return 1 << (log_l + m - r);
}

size_t tile_bytes(int m, int log_l, bool padded) {
  const size_t words = (m == 0 ? 1 : (size_t)1 << (m - 1)) +
                       ((size_t)((1 << m) + (padded ? 1 : 0)) << log_l);
  return words * sizeof(uint64_t);
}

int allow_shared(const void* kernel) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SHARED);
}

int launch_check(int threads, size_t shared) {
  if (threads > MAX_THREADS || shared > (size_t)MAX_SHARED) return -1;
  return 0;
}

}  // namespace

extern "C" {

// One pass: x [w, 2^m] (or [w, 2^log_src] coefficients when `pre` holds
// shift^i, zero-extended to 2^m) -> y [w, 2^m]; lines of 2^log_l rows.
int p2_ntt_rows(const void* x, void* y, const void* tw, const void* pre,
                int64_t w, int m, int log_src, int log_l, int scale,
                uint64_t n_inv, void* stream) {
  const int threads = tile_threads(m, log_l);
  const size_t shared = tile_bytes(m, log_l, true);
  int err = launch_check(threads, shared);
  if (err == 0) err = allow_shared((const void*)ntt_rows_kernel);
  if (err != 0) return err;
  const unsigned blocks = (unsigned)((w + (1 << log_l) - 1) >> log_l);
  ntt_rows_kernel<<<blocks, threads, shared, (cudaStream_t)stream>>>(
      (const uint64_t*)x, (uint64_t*)y, (const uint64_t*)tw,
      (const uint64_t*)pre, w, m, log_src, log_l, scale, n_inv);
  return (int)cudaGetLastError();
}

// Pass 1 of a 2^(m1 + m2)-word transform: x [w, n] (or LDE coefficients
// [w, 2^log_src] with `pre`) -> out [w, n], slabs of 2^log_l columns.
int p2_ntt_columns(const void* x, void* out, const void* tw,
                   const void* four_step, const void* pre, int64_t w, int m1,
                   int m2, int log_src, int log_l, void* stream) {
  const int threads = tile_threads(m1, log_l);
  const size_t shared = tile_bytes(m1, log_l, false);
  int err = launch_check(threads, shared);
  if (err == 0) err = allow_shared((const void*)ntt_columns_kernel);
  if (err != 0) return err;
  const unsigned blocks = (unsigned)(w << (m2 - log_l));
  ntt_columns_kernel<<<blocks, threads, shared, (cudaStream_t)stream>>>(
      (const uint64_t*)x, (uint64_t*)out, (const uint64_t*)tw,
      (const uint64_t*)four_step, (const uint64_t*)pre, m1, m2, log_src,
      log_l);
  return (int)cudaGetLastError();
}

// Pass 2: x [w, n] from pass 1 -> y [w, n] in natural order, blocks of
// 2^log_l rows k1.
int p2_ntt_rows_t(const void* x, void* y, const void* tw, int64_t w, int m1,
                  int m2, int log_l, void* stream) {
  const int threads = tile_threads(m2, log_l);
  const size_t shared = tile_bytes(m2, log_l, true);
  int err = launch_check(threads, shared);
  if (err == 0) err = allow_shared((const void*)ntt_rows_t_kernel);
  if (err != 0) return err;
  const unsigned blocks = (unsigned)(w << (m1 - log_l));
  ntt_rows_t_kernel<<<blocks, threads, shared, (cudaStream_t)stream>>>(
      (const uint64_t*)x, (uint64_t*)y, (const uint64_t*)tw, m1, m2, log_l);
  return (int)cudaGetLastError();
}

}  // extern "C"
