// One Goldilocks operation per kernel, for counting its instructions in SASS
// (bounds.py: `cuobjdump -sass` of this file's build).  probe_xor is the
// baseline: the same loads, stores and indexing around a 64-bit xor (two
// 32-bit LOP3s).  Not part of the kernel library.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

#define PROBE(name, expr)                                                    \
  extern "C" __global__ void name(uint64_t* __restrict__ a,                  \
                                  const uint64_t* __restrict__ b,            \
                                  uint64_t* __restrict__ c) {                \
    const unsigned i = threadIdx.x;                                          \
    const uint64_t x = a[i], y = b[i];                                       \
    uint64_t lo = c[i], hi = c[i + 1024];                                    \
    expr;                                                                    \
    c[i] = lo;                                                               \
    c[i + 1024] = hi;                                                        \
  }

PROBE(probe_xor, lo = x ^ y)
PROBE(probe_add, lo = gl::add(x, y))
PROBE(probe_sub, lo = gl::sub(x, y))
PROBE(probe_mul, lo = gl::mul(x, y))
PROBE(probe_reduce, lo = gl::reduce128(x, y))
// The MDS layer's product by a small matrix entry y < 2^32, accumulated
// exactly into two 64-bit sums (poseidon.cu mds_layer).
PROBE(probe_small_mul, (lo += (x & 0xFFFFFFFFull) * (uint32_t)y,
                        hi += (x >> 32) * (uint32_t)y))
