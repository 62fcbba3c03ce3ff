// K5: the quotient's constraint evaluation over the LDE coset as one
// hand-written CUDA kernel for Hopper (sm_90a).
//
// Replaces the prover's chunked eager evaluation (plonky2_bn254_tpu_torch/
// prover/prove.py, `_make_quotient`; in the reference the quotient stage of
// plonky2_bn254_tpu/prover/prove.py), which ran every Goldilocks operation
// of the constraint system as ~30 int64 elementwise kernels over chunks of
// 2^14 points, so the host's launches bounded it.
//
// Input: a tape (prover/tape.py), a machine's whole constraint system
// recorded once as a straight-line program: the AIR, the LogUp helpers and
// Z recurrences, the CTL Z's with their selectors, the alpha combination
// per challenge set and the division by Z_H.  An instruction is four int32
// words (op, dst, a, b); an operand is (source << 24) | index, a source
// being a slot, the uniform table, a trace or aux LDE column at this point
// or at the next row's point, or a selector row (z_last, l_first, l_last,
// 1/Z_H).
//
// Design: one thread per coset point, every thread running the same tape,
// so no branch diverges.  A block first fills the uniform table in shared
// memory (the constants, the scalar inputs: alphas, betas, gammas, CTL
// totals; then thread 0 runs the uniform program: operations on those
// alone, e.g. powers of beta).  The tape then streams through shared memory
// in tiles of TILE instructions, each read by all threads as a broadcast.
// Slots live in a per-thread local array (L1, spilling to L2), allocated by
// liveness on the host so that a point holds only what is still to be
// read.  LDE values are read straight from their columns at i and at
// (i + shift) mod n: the next row's point is `shift` = 2^rate_bits points
// on, so no rolled copy of the LDEs is made; a mesh rank passes its
// halo-extended next rows with shift 0.  The outputs, one row per challenge
// set, are the quotient's values on the coset, ready for the iNTT.
//
// Every operation is goldilocks.cuh's, canonical in and out, so the values
// are the eager path's bit for bit.
#include <cstdint>

#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int TILE = 512;  // tape instructions in shared memory at a time
constexpr int SRC_SHIFT = 24;
constexpr uint32_t INDEX_MASK = (1u << SRC_SHIFT) - 1;
constexpr int MAX_SHARED = 227 * 1024;

enum Src { SLOT = 0, UNI = 1, TLOC = 2, TNXT = 3, ALOC = 4, ANXT = 5, SEL = 6 };
enum Op { ADD = 0, SUB = 1, MUL = 2, OUT = 3 };

struct Columns {
  const uint64_t* t;    // trace LDE [w, n]
  const uint64_t* tn;   // its next rows: tn[j, (i + tn_shift) % n]
  const uint64_t* a;    // aux LDE [aux, n]
  const uint64_t* an;   // its next rows
  const uint64_t* sel;  // [4, n]
  uint64_t* out;        // [outputs, n]
  int64_t tn_shift, an_shift, n;
};

__device__ __forceinline__ uint64_t apply(int op, uint64_t x, uint64_t y) {
  switch (op) {
    case ADD: return gl::add(x, y);
    case SUB: return gl::sub(x, y);
    default: return gl::mul(x, y);
  }
}

__device__ __forceinline__ uint64_t fetch(uint32_t e, const uint64_t* slots,
                                          const uint64_t* uni, const Columns& c,
                                          int64_t i, int64_t it, int64_t ia) {
  const int64_t j = e & INDEX_MASK;
  switch (e >> SRC_SHIFT) {
    case SLOT: return slots[j];
    case UNI: return uni[j];
    case TLOC: return __ldg(c.t + j * c.n + i);
    case TNXT: return __ldg(c.tn + j * c.n + it);
    case ALOC: return __ldg(c.a + j * c.n + i);
    case ANXT: return __ldg(c.an + j * c.n + ia);
    default: return __ldg(c.sel + j * c.n + i);
  }
}

template <int MAXS>
__global__ void __launch_bounds__(THREADS)
quotient_tape_kernel(const int4* __restrict__ prog, int n_prog,
                     const int4* __restrict__ uprog, int n_uprog,
                     const uint64_t* __restrict__ consts, int n_consts,
                     const uint64_t* __restrict__ inputs, int n_inputs,
                     Columns c) {
  extern __shared__ uint64_t smem[];
  int4* tile = reinterpret_cast<int4*>(smem);
  uint64_t* uni = smem + 2 * TILE;
  for (int k = threadIdx.x; k < n_consts + n_inputs; k += THREADS)
    uni[k] = k < n_consts ? consts[k] : inputs[k - n_consts];
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 0; k < n_uprog; ++k) {
      const int4 in = uprog[k];
      uni[in.y] = apply(in.x, uni[in.z], uni[in.w]);
    }
  }
  const int64_t g = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const bool active = g < c.n;
  const int64_t i = active ? g : 0;  // idle lanes run point 0 and store nothing
  const int64_t it = (i + c.tn_shift) % c.n;
  const int64_t ia = (i + c.an_shift) % c.n;
  uint64_t slots[MAXS];
  for (int base = 0; base < n_prog; base += TILE) {
    const int cnt = min(TILE, n_prog - base);
    __syncthreads();  // the last tile is read (and, first, the uniforms written)
    for (int k = threadIdx.x; k < cnt; k += THREADS) tile[k] = prog[base + k];
    __syncthreads();
    for (int k = 0; k < cnt; ++k) {
      const int4 in = tile[k];
      const uint64_t x = fetch((uint32_t)in.z, slots, uni, c, i, it, ia);
      if (in.x == OUT) {
        if (active) c.out[(int64_t)in.y * c.n + g] = x;
        continue;
      }
      const uint64_t y = fetch((uint32_t)in.w, slots, uni, c, i, it, ia);
      slots[in.y] = apply(in.x, x, y);
    }
  }
}

template <int MAXS>
int launch(const int4* prog, int n_prog, const int4* uprog, int n_uprog,
           const uint64_t* consts, int n_consts, const uint64_t* inputs,
           int n_inputs, const Columns& c, cudaStream_t stream) {
  const size_t shared =
      (size_t)TILE * sizeof(int4) +
      (size_t)(n_consts + n_inputs + n_uprog) * sizeof(uint64_t);
  if (shared > (size_t)MAX_SHARED) return -1;
  int err = (int)cudaFuncSetAttribute(quotient_tape_kernel<MAXS>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)shared);
  if (err != 0) return err;
  const unsigned blocks = (unsigned)((c.n + THREADS - 1) / THREADS);
  quotient_tape_kernel<MAXS><<<blocks, THREADS, shared, stream>>>(
      prog, n_prog, uprog, n_uprog, consts, n_consts, inputs, n_inputs, c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest slot count a tape may need.
int p2_quotient_max_slots() { return 2048; }

// out [outputs, n] = the tape at every point i < n of the coset block.
int p2_quotient_tape(const void* prog, int n_prog, const void* uprog,
                     int n_uprog, const void* consts, int n_consts,
                     const void* inputs, int n_inputs, int n_slots,
                     const void* t, const void* tn, int64_t tn_shift,
                     const void* a, const void* an, int64_t an_shift,
                     const void* sel, void* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  const Columns c{(const uint64_t*)t, (const uint64_t*)tn, (const uint64_t*)a,
                  (const uint64_t*)an, (const uint64_t*)sel, (uint64_t*)out,
                  tn_shift, an_shift, n};
  const int4* p = (const int4*)prog;
  const int4* u = (const int4*)uprog;
  const uint64_t* k = (const uint64_t*)consts;
  const uint64_t* x = (const uint64_t*)inputs;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_slots <= 64) return launch<64>(p, n_prog, u, n_uprog, k, n_consts, x, n_inputs, c, s);
  if (n_slots <= 512) return launch<512>(p, n_prog, u, n_uprog, k, n_consts, x, n_inputs, c, s);
  if (n_slots <= 2048) return launch<2048>(p, n_prog, u, n_uprog, k, n_consts, x, n_inputs, c, s);
  return -1;
}

}  // extern "C"
