// K6: a batch of Goldilocks inverses as one hand-written CUDA kernel for
// Hopper (sm_90a).
//
// Replaces no pallas_call: the reference inverts in XLA
// (plonky2_bn254_tpu/field/goldilocks.py batch_inv).  The port's plain
// version (plonky2_bn254_tpu_torch/field/goldilocks.py batch_inv) is
// Montgomery's trick built from int64 tensor operations: prefix products
// by doubling over rows of 1,024, a recursion on the row totals, a Fermat
// chain at the end, ~7,000 elementwise kernels and ~16 KB of device memory
// moved for each 8-byte element.  The prover inverts whole vectors of
// independent elements with it (the LogUp helper columns and table, the CTL
// denominators, the FRI oracle's norms, the domain's selectors).
//
// Bound on the H100: bytes.  Each element is read once and written once
// (16 bytes) and costs three products (a prefix product on the way up, two
// on the way down), ~90 int32 instructions: below the card's balance of
// ~160 instructions per 16 bytes.
//
// Design: Montgomery's trick with every product kept on chip, one tile of
// BLOCK = THREADS * PER_THREAD consecutive elements a block.  The block
// copies its tile into shared memory (cp.async), each thread exactly the
// elements it reads: t, t + THREADS, ... of the tile, so each warp access
// is 256 contiguous bytes and the tile needs no barrier.  A thread forms
// the prefix products of its run in registers, writes each element back
// reduced mod p (a zero, and the ragged tail past n, as 1) and keeps a bit
// mask of its zeros.  The thread totals combine by warp shuffles: each lane
// gets the product of the other lanes' totals (an inclusive scan up and one
// down the warp, each shifted by one).  Warp 0 does the same over the warp
// totals and makes the tile's one Fermat inversion of their product (a
// fixed addition chain for p - 2: 64 squarings and 9 products), so each
// warp gets the inverse of its total and each thread the inverse of its
// own.  The thread then walks its run back down: 1/a_k = 1/c_k * c_(k-1),
// 1/c_(k-1) = 1/c_k * a_k, and writes 0 where its mask says zero, so a zero
// does not poison its neighbours.
//
// In practice the products' integer instructions, not the bytes, set the
// pace (a copy of the same bytes takes ~0.82 of the bound), so the design
// spends few of them beyond the three an element: runs of 16 elements
// halve the scans' share against runs of 8, and the Fermat chain, which a
// whole warp executes for one value, is paid once per 4,096 elements.
// Elements wait in shared memory, not registers, so 4 blocks fit an SM and
// one block's Fermat chain overlaps the others' work.  Every product is
// goldilocks.cuh's, canonical in and out, and an inverse is unique: the
// output equals the plain version's bit for bit on canonical input.
#include <cstdint>

#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 16;  // at most 32: the zero mask is 32 bits
constexpr int WARPS = THREADS / 32;
constexpr int64_t BLOCK = (int64_t)THREADS * PER_THREAD;
constexpr int MIN_BLOCKS = 4;  // 64 registers a thread, 32 KB of tile a block
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ void copy_async(uint64_t* dst, const uint64_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

// The product of the other lanes' values in each segment of `width` lanes
// (a power of two up to 32), and the segment's total in `total`.
__device__ __forceinline__ uint64_t others(uint64_t v, int width, uint64_t* total) {
  const int pos = threadIdx.x & (width - 1);
  uint64_t up = v, down = v;
  for (int d = 1; d < width; d <<= 1) {
    const uint64_t from_below = __shfl_up_sync(FULL, up, d, width);
    const uint64_t from_above = __shfl_down_sync(FULL, down, d, width);
    if (pos >= d) up = gl::mul(up, from_below);
    if (pos + d < width) down = gl::mul(down, from_above);
  }
  uint64_t below = __shfl_up_sync(FULL, up, 1, width);
  uint64_t above = __shfl_down_sync(FULL, down, 1, width);
  if (pos == 0) below = 1;
  if (pos == width - 1) above = 1;
  *total = __shfl_sync(FULL, up, width - 1, width);
  return gl::mul(below, above);
}

__device__ __forceinline__ uint64_t sqn(uint64_t x, int n) {
  for (int i = 0; i < n; ++i) x = gl::mul(x, x);
  return x;
}

// x^(p - 2) = 1/x for x != 0.  p - 2 = (2^31 - 1) * 2^33 + (2^32 - 1), and
// e_k = x^(2^k - 1) by e_(j+k) = e_j^(2^k) * e_k.
__device__ __forceinline__ uint64_t fermat_inverse(uint64_t x) {
  const uint64_t e2 = gl::mul(sqn(x, 1), x);
  const uint64_t e3 = gl::mul(sqn(e2, 1), x);
  const uint64_t e6 = gl::mul(sqn(e3, 3), e3);
  const uint64_t e12 = gl::mul(sqn(e6, 6), e6);
  const uint64_t e24 = gl::mul(sqn(e12, 12), e12);
  const uint64_t e30 = gl::mul(sqn(e24, 6), e6);
  const uint64_t e31 = gl::mul(sqn(e30, 1), x);
  const uint64_t e32 = gl::mul(sqn(e31, 1), x);
  return gl::mul(sqn(e31, 33), e32);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
batch_inverse_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, int64_t n) {
  __shared__ uint64_t tile[BLOCK];
  __shared__ uint64_t warp_total[WARPS];
  __shared__ uint64_t warp_inv[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int64_t i = base + (int64_t)k * THREADS;
    if (i < n) copy_async(tile + k * THREADS + threadIdx.x, x + i);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  uint32_t zeros = 0;  // bit k: element k of the run is 0 mod p
  uint64_t c[PER_THREAD];  // prefix products of the run
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    uint64_t v = 1;
    if (base + (int64_t)k * THREADS < n) {
      v = tile[k * THREADS + threadIdx.x];
      v = v >= gl::P ? v - gl::P : v;
      if (v == 0) {
        zeros |= 1u << k;
        v = 1;
      }
      tile[k * THREADS + threadIdx.x] = v;
    }
    c[k] = k == 0 ? v : gl::mul(c[k - 1], v);
  }

  uint64_t total;
  const uint64_t lane_others = others(c[PER_THREAD - 1], 32, &total);
  if (lane == 0) warp_total[warp] = total;
  __syncthreads();
  if (warp == 0) {  // every lane computes the same inverse of the tile's product
    const uint64_t mine = lane < WARPS ? warp_total[lane] : 1;
    uint64_t product;
    const uint64_t warp_others = others(mine, WARPS, &product);
    const uint64_t inv = fermat_inverse(__shfl_sync(FULL, product, 0));
    if (lane < WARPS) warp_inv[lane] = gl::mul(warp_others, inv);
  }
  __syncthreads();

  uint64_t inv_c = gl::mul(warp_inv[warp], lane_others);  // 1 / (this run's product)
#pragma unroll
  for (int k = PER_THREAD - 1; k >= 0; --k) {
    const int64_t i = base + (int64_t)k * THREADS;
    if (i >= n) continue;  // the tail counted as 1: inv_c stays
    const uint64_t inv_a = k > 0 ? gl::mul(inv_c, c[k - 1]) : inv_c;
    if (k > 0) inv_c = gl::mul(inv_c, tile[k * THREADS + threadIdx.x]);
    y[i] = (zeros >> k) & 1 ? 0 : inv_a;
  }
}

}  // namespace

extern "C" {

// Elements in a tile (the emulation's geometry must match).
int64_t p2_batch_inverse_block() { return BLOCK; }

// y[i] = 1 / (x[i] mod p) for i < n, 0 where x[i] = 0 mod p.
int p2_batch_inverse(const void* x, void* y, int64_t n, void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + BLOCK - 1) / BLOCK;
  if (blocks > 0x7FFFFFFF) return -1;
  batch_inverse_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)x, (uint64_t*)y, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
