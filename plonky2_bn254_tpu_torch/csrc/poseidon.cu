// Poseidon over Goldilocks (width 12, rate 8, x^7 S-box, 8 full + 22 partial
// rounds) as hand-written CUDA kernels for Hopper (sm_90a).
//
// K1 p2_hash_leaves replaces plonky2_bn254_tpu/field/poseidon_pallas.py
//    _leaf_hash_fn (body _make_leaf_kernel): the overwrite-mode sponge of
//    every row of an [N, W] leaf matrix -> [N, 4] digests.  Merkle levels
//    reuse it on [m, 8] pair rows (two_to_one(l, r) == hash_no_pad(l || r)).
// K2 p2_permute_states replaces poseidon_pallas.py _permute_states_fn: the
//    raw permutation of [N, 12] states, for the FRI proof-of-work grind.
//
// Bound on the H100: integer multiply throughput.  One permutation is ~470
// Goldilocks products (each a 64x64->128 multiply and a reduction) plus 30
// MDS layers of 144 small-constant products; a row of the 781-wide trace
// runs 98 permutations over 6.2 KB of input, so the work is ~40 integer ops
// per input byte, far above the card's ops-per-byte balance.
//
// Design: one thread per row.  The 12-word state lives in registers
// (fully unrolled element loops); round constants and the MDS matrix sit in
// __constant__ memory, read uniformly by the warp.  The TPU kernel's
// (8, 128) tiling and its padding of N to 1024 do not carry over: any N >= 1
// and any W (including W = 0) are taken.  Rows are read with a stride of W
// words, uncoalesced across the warp; each thread reads a contiguous 64-byte
// chunk per absorb, so whole sectors are still used.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int WIDTH = 12;
constexpr int RATE = 8;
constexpr int HALF_FULL = 4;
constexpr int PARTIAL = 22;
constexpr int N_ROUNDS = 2 * HALF_FULL + PARTIAL;

__constant__ uint64_t c_rc[N_ROUNDS * WIDTH];
__constant__ uint32_t c_mds[WIDTH * WIDTH];

__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  const uint64_t x2 = gl::mul(x, x);
  const uint64_t x4 = gl::mul(x2, x2);
  const uint64_t x6 = gl::mul(x4, x2);
  return gl::mul(x6, x);
}

// MDS @ state: exact 128-bit row sums from 32-bit halves times the small
// entries (each half-sum < 2^42), then one reduction per output.
__device__ __forceinline__ void mds_layer(uint64_t s[WIDTH]) {
  uint64_t out[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; i++) {
    uint64_t acc_lo = 0, acc_hi = 0;
#pragma unroll
    for (int j = 0; j < WIDTH; j++) {
      const uint64_t m = c_mds[i * WIDTH + j];
      acc_lo += (s[j] & 0xFFFFFFFFull) * m;
      acc_hi += (s[j] >> 32) * m;
    }
    const uint64_t lo = acc_lo + (acc_hi << 32);
    const uint64_t hi = (acc_hi >> 32) + (lo < acc_lo ? 1ull : 0ull);
    out[i] = gl::reduce128(hi, lo);
  }
#pragma unroll
  for (int i = 0; i < WIDTH; i++) s[i] = out[i];
}

__device__ __forceinline__ void full_round(uint64_t s[WIDTH], int r) {
#pragma unroll
  for (int e = 0; e < WIDTH; e++) s[e] = sbox(gl::add(s[e], c_rc[r * WIDTH + e]));
  mds_layer(s);
}

__device__ __forceinline__ void partial_round(uint64_t s[WIDTH], int r) {
#pragma unroll
  for (int e = 0; e < WIDTH; e++) s[e] = gl::add(s[e], c_rc[r * WIDTH + e]);
  s[0] = sbox(s[0]);
  mds_layer(s);
}

__device__ void permute(uint64_t s[WIDTH]) {
  int r = 0;
#pragma unroll 1
  for (int k = 0; k < HALF_FULL; k++, r++) full_round(s, r);
#pragma unroll 1
  for (int k = 0; k < PARTIAL; k++, r++) partial_round(s, r);
#pragma unroll 1
  for (int k = 0; k < HALF_FULL; k++, r++) full_round(s, r);
}

__global__ void hash_leaves_kernel(const uint64_t* __restrict__ leaves,
                                   uint64_t* __restrict__ out, int64_t n,
                                   int64_t w) {
  const int64_t row = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (row >= n) return;
  const uint64_t* src = leaves + row * w;
  uint64_t s[WIDTH];
#pragma unroll
  for (int e = 0; e < WIDTH; e++) s[e] = 0;
  for (int64_t c = 0; c < w; c += RATE) {
    if (c + RATE <= w) {
#pragma unroll
      for (int e = 0; e < RATE; e++) s[e] = src[c + e];
    } else {
#pragma unroll
      for (int e = 0; e < RATE; e++) s[e] = c + e < w ? src[c + e] : 0ull;
    }
    permute(s);
  }
#pragma unroll
  for (int e = 0; e < 4; e++) out[row * 4 + e] = s[e];
}

__global__ void permute_states_kernel(const uint64_t* __restrict__ in,
                                      uint64_t* __restrict__ out, int64_t n) {
  const int64_t row = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (row >= n) return;
  uint64_t s[WIDTH];
#pragma unroll
  for (int e = 0; e < WIDTH; e++) s[e] = in[row * WIDTH + e];
  permute(s);
#pragma unroll
  for (int e = 0; e < WIDTH; e++) out[row * WIDTH + e] = s[e];
}

constexpr int THREADS = 128;

unsigned blocks_for(int64_t n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

extern "C" {

// Installs the round constants [30 * 12] and the MDS matrix [12 * 12] on the
// current device; the host owns the tables (poseidon_constants.py).
int p2_poseidon_init(const uint64_t* rc, const uint32_t* mds) {
  cudaMemcpyToSymbol(c_rc, rc, sizeof(uint64_t) * N_ROUNDS * WIDTH);
  cudaMemcpyToSymbol(c_mds, mds, sizeof(uint32_t) * WIDTH * WIDTH);
  return (int)cudaGetLastError();
}

int p2_hash_leaves(const void* leaves, void* out, int64_t n, int64_t w, void* stream) {
  hash_leaves_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)leaves, (uint64_t*)out, n, w);
  return (int)cudaGetLastError();
}

int p2_permute_states(const void* in, void* out, int64_t n, void* stream) {
  permute_states_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
