// Goldilocks field arithmetic (p = 2^64 - 2^32 + 1) for the Hopper kernels.
//
// Replaces the u32-pair helpers of plonky2_bn254_tpu/field/poseidon_pallas.py
// (gl_add, _mul32, _reduce128, gl_mul) and ntt_pallas.py (gl_sub).  Each
// function follows plonky2_bn254_tpu/field/goldilocks.py step by step, so it
// returns the same bit pattern as the JAX reference for every u64 input.
#pragma once

#include <cstdint>

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 - p

// Each function is one PTX block on 32-bit halves with carry chains: carries
// and borrows go straight into the next instruction instead of through 64-bit
// compares and selects, which cost the C++ form a fifth more SASS
// instructions.  Each step is the reference's, modulo 2^64.

__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  // s = a + b; if it wrapped, s += 2^64 - p; then s >= p ? s - p : s
  uint64_t r;
  asm("{\n\t"
      ".reg .u32 a0, a1, b0, b1, s0, s1, m, v0, v1, f;\n\t"
      ".reg .pred p;\n\t"
      "mov.b64 {a0, a1}, %1;\n\t"
      "mov.b64 {b0, b1}, %2;\n\t"
      "add.cc.u32 s0, a0, b0;\n\t"
      "addc.cc.u32 s1, a1, b1;\n\t"
      "addc.u32 m, 0, 0;\n\t"
      "neg.s32 m, m;\n\t"
      "add.cc.u32 s0, s0, m;\n\t"
      "addc.u32 s1, s1, 0;\n\t"
      "add.cc.u32 v0, s0, 0xFFFFFFFF;\n\t"
      "addc.cc.u32 v1, s1, 0;\n\t"
      "addc.u32 f, 0, 0;\n\t"
      "setp.ne.u32 p, f, 0;\n\t"
      "selp.b32 s0, v0, s0, p;\n\t"
      "selp.b32 s1, v1, s1, p;\n\t"
      "mov.b64 %0, {s0, s1};\n\t"
      "}"
      : "=l"(r) : "l"(a), "l"(b));
  return r;
}

__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  // d = a - b; if it wrapped, d -= 2^64 - p (want +p, not +2^64)
  uint64_t r;
  asm("{\n\t"
      ".reg .u32 a0, a1, b0, b1, d0, d1, m;\n\t"
      "mov.b64 {a0, a1}, %1;\n\t"
      "mov.b64 {b0, b1}, %2;\n\t"
      "sub.cc.u32 d0, a0, b0;\n\t"
      "subc.cc.u32 d1, a1, b1;\n\t"
      "subc.u32 m, 0, 0;\n\t"
      "sub.cc.u32 d0, d0, m;\n\t"
      "subc.u32 d1, d1, 0;\n\t"
      "mov.b64 %0, {d0, d1};\n\t"
      "}"
      : "=l"(r) : "l"(a), "l"(b));
  return r;
}

// (h3 h2 l1 l0) = h * 2^64 + l mod p, canonical: 2^64 = 2^32 - 1 and
// 2^96 = -1 (mod p).  t = l - h3 (less 2^64 - p if that wrapped), plus
// h2 * (2^32 - 1) (plus 2^64 - p if that wrapped), then t >= p ? t - p : t.
#define GL_REDUCE_PTX                          \
  "sub.cc.u32 t0, l0, h3;\n\t"                 \
  "subc.cc.u32 t1, l1, 0;\n\t"                 \
  "subc.u32 m, 0, 0;\n\t"                      \
  "sub.cc.u32 t0, t0, m;\n\t"                  \
  "subc.u32 t1, t1, 0;\n\t"                    \
  "sub.cc.u32 u0, 0, h2;\n\t"                  \
  "subc.u32 u1, h2, 0;\n\t"                    \
  "add.cc.u32 t0, t0, u0;\n\t"                 \
  "addc.cc.u32 t1, t1, u1;\n\t"                \
  "addc.u32 m, 0, 0;\n\t"                      \
  "neg.s32 m, m;\n\t"                          \
  "add.cc.u32 t0, t0, m;\n\t"                  \
  "addc.u32 t1, t1, 0;\n\t"                    \
  "add.cc.u32 u0, t0, 0xFFFFFFFF;\n\t"         \
  "addc.cc.u32 u1, t1, 0;\n\t"                 \
  "addc.u32 m, 0, 0;\n\t"                      \
  "setp.ne.u32 p, m, 0;\n\t"                   \
  "selp.b32 t0, u0, t0, p;\n\t"                \
  "selp.b32 t1, u1, t1, p;\n\t"                \
  "mov.b64 %0, {t0, t1};\n\t"

__device__ __forceinline__ uint64_t reduce128(uint64_t hi, uint64_t lo) {
  uint64_t r;
  asm("{\n\t"
      ".reg .u32 l0, l1, h2, h3, t0, t1, u0, u1, m;\n\t"
      ".reg .pred p;\n\t"
      "mov.b64 {l0, l1}, %2;\n\t"
      "mov.b64 {h2, h3}, %1;\n\t"
      GL_REDUCE_PTX
      "}"
      : "=l"(r) : "l"(hi), "l"(lo));
  return r;
}

// The 64x64 -> 128-bit product in 32-bit multiply-adds, then the reduction.
__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  uint64_t r;
  asm("{\n\t"
      ".reg .u32 a0, a1, b0, b1, l0, l1, h2, h3, t0, t1, u0, u1, m;\n\t"
      ".reg .pred p;\n\t"
      "mov.b64 {a0, a1}, %1;\n\t"
      "mov.b64 {b0, b1}, %2;\n\t"
      "mul.lo.u32 l0, a0, b0;\n\t"
      "mul.hi.u32 l1, a0, b0;\n\t"
      "mad.lo.cc.u32 l1, a0, b1, l1;\n\t"
      "madc.hi.u32 h2, a0, b1, 0;\n\t"
      "mad.lo.cc.u32 l1, a1, b0, l1;\n\t"
      "madc.hi.cc.u32 h2, a1, b0, h2;\n\t"
      "madc.hi.u32 h3, a1, b1, 0;\n\t"
      "mad.lo.cc.u32 h2, a1, b1, h2;\n\t"
      "addc.u32 h3, h3, 0;\n\t"
      GL_REDUCE_PTX
      "}"
      : "=l"(r) : "l"(a), "l"(b));
  return r;
}

#undef GL_REDUCE_PTX

}  // namespace gl
