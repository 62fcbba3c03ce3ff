// One Goldilocks operation per kernel, for counting its instructions in SASS
// (bounds.py: `cuobjdump -sass` of this file's build).  probe_xor is the
// baseline: the same loads, stores and indexing around a 64-bit xor (two
// 32-bit LOP3s).  Below them, clock64() chains that measure each
// operation's latency, and K2t's one-thread rung.  Not part of the kernel
// library.
#include <cuda_runtime.h>

#include "goldilocks.cuh"
#include "poseidon.cu"

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

// Latency: one thread runs a chain of dependent operations (each step's
// input is the previous step's output) and reads clock64() around it.
// Cycles per step = (cycles of LAT_STEPS steps - cycles of LAT_BASE steps)
// / (LAT_STEPS - LAT_BASE): the loads, stores and clock reads around the
// chain cancel.  bounds.op_latencies builds this file as a library and
// calls p2_op_latencies; bounds.OP_LATENCY pins what it reads.
constexpr int LAT_STEPS = 4096;
constexpr int LAT_BASE = 1024;
constexpr int LAT_UNROLL = 16;

__device__ __forceinline__ long long clock_now() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}

#define LATENCY(name, step)                                                      \
  __device__ __forceinline__ uint64_t name##_step(uint64_t x, uint64_t y) {      \
    step;                                                                        \
    return x;                                                                    \
  }                                                                              \
  extern "C" __global__ void name(const uint64_t* __restrict__ in,              \
                                  uint64_t* __restrict__ out,                   \
                                  long long* __restrict__ cycles) {             \
    const volatile uint64_t* src = in;                                           \
    const int counts[2] = {LAT_BASE, LAT_STEPS};                                 \
    for (int k = 0; k < 2; k++) {                                                \
      const long long t0 = clock_now();                                          \
      uint64_t x = src[0];                                                       \
      const uint64_t y = src[1];                                                 \
      for (int i = 0; i < counts[k]; i += LAT_UNROLL) {                          \
        _Pragma("unroll") for (int u = 0; u < LAT_UNROLL; u++) x = name##_step(x, y); \
      }                                                                          \
      ((volatile uint64_t*)out)[k] = x;                                          \
      cycles[k] = clock_now() - t0;                                              \
    }                                                                            \
  }

LATENCY(latency_add, x = gl::add(x, y))
LATENCY(latency_mul, x = gl::mul(x, y))
LATENCY(latency_reduce, x = gl::reduce128(x, y))
// one multiply-accumulate of the MDS sum: a 32-bit half times a small
// entry into a 64-bit sum, the sum feeding the next step
LATENCY(latency_small_mul, x = (x & 0xFFFFFFFFull) * (uint32_t)y + x)
// one add of two 64-bit partial sums, a level of the MDS sum's tree (in
// PTX, so that the compiler cannot fold the chain into one product)
LATENCY(latency_sum_add, asm volatile("add.u64 %0, %0, %1;" : "+l"(x) : "l"(y)))

constexpr int LAT_OPS = 5;

// Runs the chains on the current device: cycles[2 * i + k] for op i (add,
// mul, reduce, small_mul, sum_add) and chain length k (LAT_BASE,
// LAT_STEPS); `scratch`: 2 device words of input (x0, y) and 2 * LAT_OPS
// of output.
extern "C" int p2_op_latencies(void* scratch, long long* cycles_host) {
  long long* d_cycles = nullptr;
  cudaError_t err = cudaMalloc(&d_cycles, 2 * LAT_OPS * sizeof(long long));
  if (err != cudaSuccess) return (int)err;
  uint64_t* in = (uint64_t*)scratch;
  uint64_t* out = in + 2;
  latency_add<<<1, 1>>>(in, out, d_cycles);
  latency_mul<<<1, 1>>>(in, out + 2, d_cycles + 2);
  latency_reduce<<<1, 1>>>(in, out + 4, d_cycles + 4);
  latency_small_mul<<<1, 1>>>(in, out + 6, d_cycles + 6);
  latency_sum_add<<<1, 1>>>(in, out + 8, d_cycles + 8);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpy(cycles_host, d_cycles, 2 * LAT_OPS * sizeof(long long),
                     cudaMemcpyDeviceToHost);
  cudaFree(d_cycles);
  return (int)err;
}

// K2t's one-thread rung: the transition of poseidon.cu's
// sponge_transition_kernel on one thread, over `permute` (the throughput
// kernels' permutation: the 12 words in that thread's registers, the
// partial rounds sparse), the design K2t was first measured against
// (scripts/torch_k2t_rung.py).  Its constants: this library's own
// p2_poseidon_init.
namespace {

__global__ void sponge_transition_1t_kernel(const uint64_t* __restrict__ state_in,
                                            uint64_t* __restrict__ out,
                                            const __grid_constant__ SpongeArgs a) {
  uint64_t s[WIDTH];
#pragma unroll
  for (int e = 0; e < WIDTH; e++) s[e] = state_in[e];
  const int64_t total = a.off[a.n_seg];
  const int64_t n_full = total / RATE;
  int fill = (int)(total % RATE);
  int n_out = total > 0 ? 0 : a.n_out;
  int sg = 0;
#pragma unroll 1
  for (int64_t c = 0; c < n_full; c++) {
#pragma unroll
    for (int j = 0; j < RATE; j++) s[j] = stream_word(a, c * RATE + j, sg);
    permute(s);
  }
  uint64_t buf[RATE];
#pragma unroll
  for (int j = 0; j < RATE; j++) buf[j] = j < fill ? stream_word(a, n_full * RATE + j, sg) : 0ull;
  if (n_full > 0 && fill == 0) n_out = RATE;
#pragma unroll 1
  for (int k = 0; k < a.n_squeeze; k++) {
    if (fill > 0 || n_out == 0) {
#pragma unroll
      for (int j = 0; j < RATE; j++)
        if (j < fill) s[j] = buf[j];
      permute(s);
      fill = 0;
      n_out = RATE;
    }
    n_out--;
#pragma unroll
    for (int j = 0; j < RATE; j++)
      if (j == n_out) out[WIDTH + RATE + k] = s[j];
  }
#pragma unroll
  for (int e = 0; e < WIDTH; e++) out[e] = s[e];
#pragma unroll
  for (int j = 0; j < RATE; j++)
    if (j < fill) out[WIDTH + j] = buf[j];
}

}  // namespace

// The rung with p2_sponge_transition's arguments and output layout.
extern "C" int p2_sponge_transition_1t(const void* state, void* out, const void* const* seg_ptr,
                                       const int64_t* seg_len, int n_seg, const uint64_t* imm,
                                       int n_imm, int n_out, int n_squeeze, void* stream) {
  SpongeArgs a;
  const int err = pack_sponge_args(a, seg_ptr, seg_len, n_seg, imm, n_imm, n_out, n_squeeze);
  if (err != (int)cudaSuccess) return err;
  sponge_transition_1t_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const uint64_t*)state,
                                                                 (uint64_t*)out, a);
  return (int)cudaGetLastError();
}
