// Batched Goldilocks NTT / iNTT / coset LDE as hand-written CUDA kernels for
// Hopper (sm_90a).  Natural order in and out along the last axis of [w, n].
//
// K3 (p2_ntt_local + p2_ntt_stage) replaces
//    plonky2_bn254_tpu/field/ntt_pallas.py _dft_sublane_fn (bodies
//    _make_dft_kernel, _run_stages): the four-step NTT/iNTT driven by
//    _ntt_fn.
// K4 (p2_ntt_local with a premultiply table, then p2_ntt_stage) replaces
//    ntt_pallas.py _lde_stage_a_fn: the rate-1 coset LDE (premultiply by
//    shift^i, zero-extend, forward NTT on shift * H), here for any rate.
//
// Bound on the H100: device memory.  A radix-2 butterfly is one Goldilocks
// product and two additions per 16 bytes moved, so every pass over the batch
// that leaves shared memory costs a full read and write of it.
//
// Design: bit-reverse, then radix-2 DIT stages (the order of the plain
// version in field/ntt.py).  p2_ntt_local gathers a tile of 2048 outputs
// (one segment of a long row, or several short rows) in bit-reversed order
// into shared memory, optionally premultiplying by the coset powers and
// zero-extending (K4), and runs every stage whose blocks fit the tile.  Each
// remaining stage of a row longer than the tile is one p2_ntt_stage launch,
// one thread per butterfly, in place.  The iNTT's n^-1 is folded into the
// last stage.  Twiddles come from one table of w_n^k (k < n/2); stage s reads
// it with stride n / 2^s.  The Pallas limits (2^14 <= n <= 2^20, w a multiple
// of 8) do not carry over: every power of two n and every w are taken.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int TILE_LOG = 11;
constexpr int TILE = 1 << TILE_LOG;
constexpr int THREADS = 256;

__device__ __forceinline__ int64_t bit_rev(int64_t i, int logn) {
  return logn == 0 ? 0 : (int64_t)(__brev((unsigned)i) >> (32 - logn));
}

// One tile: R = TILE / L segments of length L = min(n, TILE).  Segment g of
// the flattened [w, n / L] grid covers outputs [seg * L, seg * L + L) of row
// g / (n / L).
__global__ void ntt_local_kernel(const uint64_t* __restrict__ x,
                                 uint64_t* __restrict__ y,
                                 const uint64_t* __restrict__ tw,
                                 const uint64_t* __restrict__ pre, int64_t w,
                                 int logn, int log_src, int logl, int scale,
                                 uint64_t n_inv) {
  __shared__ uint64_t sh[TILE];
  const int L = 1 << logl;
  const int R = TILE >> logl;
  const int64_t n = 1ll << logn;
  const int64_t n_src = 1ll << log_src;
  const int64_t segs = n >> logl;
  const int64_t g0 = (int64_t)blockIdx.x * R;

  for (int t = threadIdx.x; t < TILE; t += blockDim.x) {
    const int64_t g = g0 + (t >> logl);
    const int64_t row = g / segs;
    uint64_t v = 0;
    if (row < w) {
      const int64_t pos = (g % segs) * L + (t & (L - 1));
      const int64_t src = bit_rev(pos, logn);
      if (pre == nullptr) {
        v = x[row * n + src];
      } else if (src < n_src) {
        v = gl::mul(x[row * n_src + src], pre[src]);
      }
    }
    sh[t] = v;
  }
  __syncthreads();

  for (int s = 1; s <= logl; s++) {
    const int half = 1 << (s - 1);
    for (int b = threadIdx.x; b < TILE / 2; b += blockDim.x) {
      const int r = b >> (logl - 1);
      const int bb = b & ((L >> 1) - 1);
      const int j = bb & (half - 1);
      const int i0 = (r << logl) + ((bb >> (s - 1)) << s) + j;
      const int i1 = i0 + half;
      const uint64_t t = gl::mul(sh[i1], tw[(int64_t)j << (logn - s)]);
      const uint64_t u = sh[i0];
      sh[i0] = gl::add(u, t);
      sh[i1] = gl::sub(u, t);
    }
    __syncthreads();
  }

  for (int t = threadIdx.x; t < TILE; t += blockDim.x) {
    const int64_t g = g0 + (t >> logl);
    const int64_t row = g / segs;
    if (row < w) {
      const int64_t pos = (g % segs) * L + (t & (L - 1));
      const uint64_t v = sh[t];
      y[row * n + pos] = scale ? gl::mul(v, n_inv) : v;
    }
  }
}

// One DIT stage s over the whole [w, n] batch, in place: blocks of 2^s.
__global__ void ntt_stage_kernel(uint64_t* __restrict__ y,
                                 const uint64_t* __restrict__ tw, int64_t w,
                                 int logn, int s, int scale, uint64_t n_inv) {
  const int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t half_n = 1ll << (logn - 1);
  if (idx >= w * half_n) return;
  const int64_t row = idx >> (logn - 1);
  const int64_t b = idx & (half_n - 1);
  const int64_t half = 1ll << (s - 1);
  const int64_t j = b & (half - 1);
  const int64_t i0 = (row << logn) + ((b >> (s - 1)) << s) + j;
  const int64_t i1 = i0 + half;
  const uint64_t t = gl::mul(y[i1], tw[j << (logn - s)]);
  const uint64_t u = y[i0];
  uint64_t lo = gl::add(u, t), hi = gl::sub(u, t);
  if (scale) {
    lo = gl::mul(lo, n_inv);
    hi = gl::mul(hi, n_inv);
  }
  y[i0] = lo;
  y[i1] = hi;
}

}  // namespace

extern "C" {

int p2_ntt_tile_log(void) { return TILE_LOG; }

// x: [w, n] (or [w, n_src] coefficients when `pre` is given) -> y: [w, n]
// after every stage s <= logl.  pre: shift^i for i < n_src, or null.
int p2_ntt_local(const void* x, void* y, const void* tw, const void* pre,
                 int64_t w, int logn, int log_src, int scale, uint64_t n_inv,
                 void* stream) {
  const int logl = logn < TILE_LOG ? logn : TILE_LOG;
  const int64_t segments = w << (logn - logl);
  const int64_t per_block = TILE >> logl;
  const unsigned blocks = (unsigned)((segments + per_block - 1) / per_block);
  ntt_local_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)x, (uint64_t*)y, (const uint64_t*)tw,
      (const uint64_t*)pre, w, logn, log_src, logl, scale, n_inv);
  return (int)cudaGetLastError();
}

int p2_ntt_stage(void* y, const void* tw, int64_t w, int logn, int s,
                 int scale, uint64_t n_inv, void* stream) {
  const int64_t butterflies = w << (logn - 1);
  const unsigned blocks = (unsigned)((butterflies + THREADS - 1) / THREADS);
  ntt_stage_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (uint64_t*)y, (const uint64_t*)tw, w, logn, s, scale, n_inv);
  return (int)cudaGetLastError();
}

}  // extern "C"
