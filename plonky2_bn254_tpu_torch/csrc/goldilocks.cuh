// Goldilocks field arithmetic (p = 2^64 - 2^32 + 1) for the Hopper kernels.
//
// Replaces the u32-pair helpers of plonky2_bn254_tpu/field/poseidon_pallas.py
// (gl_add, _mul32, _reduce128, gl_mul) and ntt_pallas.py (gl_sub): Mosaic had
// no 64-bit integers, CUDA has native u64 and __umul64hi.  Each function
// follows plonky2_bn254_tpu/field/goldilocks.py step by step, so it returns
// the same bit pattern as the JAX reference for every u64 input.
#pragma once

#include <cstdint>

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 - p

__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) s += EPS;  // wrapped: add back 2^64 - p
  return s >= P ? s - P : s;
}

__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  return a < b ? d - EPS : d;  // wrapped: want +p, not +2^64
}

// hi * 2^64 + lo mod p, canonical: 2^64 = 2^32 - 1 and 2^96 = -1 (mod p).
__device__ __forceinline__ uint64_t reduce128(uint64_t hi, uint64_t lo) {
  const uint64_t hi_hi = hi >> 32;
  const uint64_t hi_lo = hi & EPS;
  uint64_t t0 = lo - hi_hi;
  if (lo < hi_hi) t0 -= EPS;
  const uint64_t t1 = hi_lo * EPS;  // < 2^64
  uint64_t t = t0 + t1;
  if (t < t0) t += EPS;
  return t >= P ? t - P : t;
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  return reduce128(__umul64hi(a, b), a * b);
}

}  // namespace gl
