// Poseidon over Goldilocks (width 12, rate 8, x^7 S-box, 8 full + 22 partial
// rounds) as hand-written CUDA kernels for Hopper (sm_90a).
//
// K1 p2_hash_leaves replaces plonky2_bn254_tpu/field/poseidon_pallas.py
//    _leaf_hash_fn (body _make_leaf_kernel): the overwrite-mode sponge of
//    every row of an [N, W] leaf matrix -> [N, 4] digests.  Merkle levels
//    reuse it on [m, 8] pair rows (two_to_one(l, r) == hash_no_pad(l || r)).
// K2 p2_permute_states replaces poseidon_pallas.py _permute_states_fn: the
//    raw permutation of [N, 12] states, for the FRI proof-of-work grind.
// K2t p2_sponge_transition: one whole Fiat-Shamir transcript transition on
//    one sponge state (absorb, then squeeze); see the note at its kernel.
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

// ---------------------------------------------------------------------------
// K2t: one transcript transition.
//
// Replaces, in the device Fiat-Shamir flow, the reference's per-transition
// executable and its lax.scan absorb over rate chunks
// (plonky2_bn254_tpu/prover/device_challenger.py observe_flat, which runs
// the XLA permutation, not a Pallas kernel), and the one K2 launch at
// [1, 12] per duplex that the port made before.  One launch absorbs the
// pending input words and any number of flat vectors (device vectors, or
// words passed by value), in plonky2's overwrite mode with a permutation on
// every 8th word, then squeezes n_squeeze challenges (a duplex when input
// is buffered or no output is left; each pops from the end of state[:8]),
// and writes the new state, the leftover input words and the outputs.
//
// Bound: latency.  A transition is a chain of m dependent permutations
// (G2's opening absorb: 8,820 words, ~1,103), so throughput is idle and
// what counts is one permutation's critical path: per round the S-box's
// three dependent products and the MDS sum and reduction.
// Design: one warp on one SM.  Lane e < 12 holds state word e.  Each round
// constant is known before the round, so it is not added on the chain:
// round r + 1's constant of word e enters round r's MDS sum of row e as
// one more term before the reduction (only round 0's is a separate add).
// A full round: each lane its own S-box (x^7 = x^4 * x^3: three products
// deep), then the 12 words by shuffles (two 32-bit halves each), each
// lane summing its row's exact 128-bit value from its row of small entries
// as a tree, and one reduce128, where one thread would run 144 products in
// sequence.  A partial round: word 0 is the only S-box, so every lane takes
// word 0 by shuffle and runs that S-box itself while it sums the other 11
// words' products and the constant; word 0's product is then one
// multiply-accumulate before the reduction, and no shuffle or tree level
// waits for the S-box.  Round constants sit in shared memory, loaded during
// the round before; the next 64-byte chunk of input is loaded into
// registers while the current permutation runs, so no load sits on the
// chain.  Lanes 12..31 only take part in the shuffles.
// ---------------------------------------------------------------------------

constexpr int K2T_MAX_SEGS = 32;
constexpr int K2T_MAX_IMM = 32;
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;

// The word stream of one transition: segments in absorb order, each a
// device vector or (ptr == nullptr) words passed by value in imm.
struct SpongeArgs {
  const uint64_t* ptr[K2T_MAX_SEGS];
  int64_t off[K2T_MAX_SEGS + 1];  // stream position of each segment; off[n_seg] = total
  int imm_base[K2T_MAX_SEGS];     // a by-value segment's first word in imm
  uint64_t imm[K2T_MAX_IMM];
  int n_seg;
  int n_out;      // outputs pending at the start: state[0, n_out)
  int n_squeeze;
};

// Fills `a` from p2_sponge_transition's arguments; a CUDA error code.
int pack_sponge_args(SpongeArgs& a, const void* const* seg_ptr, const int64_t* seg_len,
                     int n_seg, const uint64_t* imm, int n_imm, int n_out, int n_squeeze) {
  if (n_seg < 0 || n_seg > K2T_MAX_SEGS || n_imm < 0 || n_imm > K2T_MAX_IMM || n_out < 0 ||
      n_out > RATE || n_squeeze < 0)
    return (int)cudaErrorInvalidValue;
  a = SpongeArgs{};
  int64_t pos = 0;
  int used = 0;
  for (int i = 0; i < n_seg; i++) {
    if (seg_len[i] < 0) return (int)cudaErrorInvalidValue;
    a.ptr[i] = (const uint64_t*)seg_ptr[i];
    a.off[i] = pos;
    a.imm_base[i] = used;
    if (a.ptr[i] == nullptr) used += (int)seg_len[i];
    pos += seg_len[i];
  }
  if (used != n_imm) return (int)cudaErrorInvalidValue;
  a.off[n_seg] = pos;
  for (int i = 0; i < n_imm; i++) a.imm[i] = imm[i];
  a.n_seg = n_seg;
  a.n_out = n_out;
  a.n_squeeze = n_squeeze;
  return (int)cudaSuccess;
}

// The stream word at position q < total; `sg` is the caller's segment
// cursor, which only moves forward because q only grows.
__device__ __forceinline__ uint64_t stream_word(const SpongeArgs& a, int64_t q, int& sg) {
  while (q >= a.off[sg + 1]) sg++;
  const int64_t i = q - a.off[sg];
  const uint64_t* p = a.ptr[sg];
  return p != nullptr ? p[i] : a.imm[a.imm_base[sg] + i];
}

__device__ __forceinline__ uint64_t sbox3(uint64_t x) {
  const uint64_t x2 = gl::mul(x, x);
  const uint64_t x3 = gl::mul(x2, x);
  const uint64_t x4 = gl::mul(x2, x2);
  return gl::mul(x4, x3);
}

// The products of this lane's MDS row by the words J0..11 of the warp
// (each taken by shuffle, two 32-bit halves) and the constant k, summed as
// a tree into two exact 64-bit sums of 32-bit halves (each < 2^42).
template <int J0>
__device__ __forceinline__ void mds_sum(uint64_t x, const uint32_t m[WIDTH], uint64_t k,
                                        uint64_t& sum_lo, uint64_t& sum_hi) {
  uint64_t plo[WIDTH], phi[WIDTH];
#pragma unroll
  for (int j = J0; j < WIDTH; j++) {
    const uint32_t lo = __shfl_sync(FULL_MASK, (uint32_t)x, j);
    const uint32_t hi = __shfl_sync(FULL_MASK, (uint32_t)(x >> 32), j);
    plo[j] = (uint64_t)lo * m[j];
    phi[j] = (uint64_t)hi * m[j];
  }
  plo[J0] += k & 0xFFFFFFFFull;
  phi[J0] += k >> 32;
#pragma unroll
  for (int w = 1; w < WIDTH - J0; w *= 2) {
#pragma unroll
    for (int j = J0; j + w < WIDTH; j += 2 * w) {
      plo[j] += plo[j + w];
      phi[j] += phi[j + w];
    }
  }
  sum_lo = plo[J0];
  sum_hi = phi[J0];
}

// sum_lo + 2^32 sum_hi mod p, canonical.
__device__ __forceinline__ uint64_t mds_finish(uint64_t sum_lo, uint64_t sum_hi) {
  const uint64_t lo = sum_lo + (sum_hi << 32);
  const uint64_t hi = (sum_hi >> 32) + (lo < sum_lo ? 1ull : 0ull);
  return gl::reduce128(hi, lo);
}

// One round on the warp's state, round r's constant already added; k: the
// next round's constant of this lane's word (0 after the last round).
__device__ __forceinline__ uint64_t full_round_warp(uint64_t x, const uint32_t m[WIDTH],
                                                    uint64_t k) {
  uint64_t lo, hi;
  mds_sum<0>(sbox3(x), m, k, lo, hi);
  return mds_finish(lo, hi);
}

__device__ __forceinline__ uint64_t partial_round_warp(uint64_t x, const uint32_t m[WIDTH],
                                                       uint64_t k) {
  const uint32_t x0_lo = __shfl_sync(FULL_MASK, (uint32_t)x, 0);
  const uint32_t x0_hi = __shfl_sync(FULL_MASK, (uint32_t)(x >> 32), 0);
  uint64_t lo, hi;
  mds_sum<1>(x, m, k, lo, hi);
  const uint64_t t = sbox3(((uint64_t)x0_hi << 32) | x0_lo);
  lo += (t & 0xFFFFFFFFull) * m[0];
  hi += (t >> 32) * m[0];
  return mds_finish(lo, hi);
}

__device__ __forceinline__ uint64_t next_constant(const uint64_t* rc, int r, int e) {
  return r + 1 < N_ROUNDS ? rc[(r + 1) * WIDTH + e] : 0ull;
}

// The permutation with the state spread over the warp (lane e holds word
// e; e is 0 on lanes 12..31).  rc: the round constants in shared memory.
__device__ __forceinline__ uint64_t permute_warp(uint64_t x, int e, const uint32_t m[WIDTH],
                                                 const uint64_t* rc) {
  x = gl::add(x, rc[e]);
  int r = 0;
#pragma unroll 1
  for (; r < HALF_FULL; r++) x = full_round_warp(x, m, next_constant(rc, r, e));
#pragma unroll 1
  for (; r < HALF_FULL + PARTIAL; r++) x = partial_round_warp(x, m, next_constant(rc, r, e));
#pragma unroll 1
  for (; r < N_ROUNDS; r++) x = full_round_warp(x, m, next_constant(rc, r, e));
  return x;
}

// out: [12] new state, [8] leftover input (the first `fill` valid), then
// the n_squeeze outputs.
__global__ void __launch_bounds__(32) sponge_transition_kernel(
    const uint64_t* __restrict__ state_in, uint64_t* __restrict__ out,
    const __grid_constant__ SpongeArgs a) {
  __shared__ uint64_t rc[N_ROUNDS * WIDTH];
  const int lane = threadIdx.x;
  const int e = lane < WIDTH ? lane : 0;
  for (int i = lane; i < N_ROUNDS * WIDTH; i += 32) rc[i] = c_rc[i];
  uint32_t m[WIDTH];
#pragma unroll
  for (int j = 0; j < WIDTH; j++) m[j] = c_mds[e * WIDTH + j];
  uint64_t x = state_in[e];
  __syncwarp();

  const int64_t total = a.off[a.n_seg];
  const int64_t n_full = total / RATE;
  int fill = (int)(total % RATE);
  int n_out = total > 0 ? 0 : a.n_out;
  int sg = 0;
  // w: on lanes 0..7, the word at stream position RATE * c + lane of the
  // chunk c to come (after the loop: the leftover words)
  uint64_t w = 0;
  if (lane < RATE && lane < total) w = stream_word(a, lane, sg);
#pragma unroll 1
  for (int64_t c = 0; c < n_full; c++) {
    const uint64_t cur = w;
    const int64_t q = (c + 1) * RATE + lane;
    if (lane < RATE && q < total) w = stream_word(a, q, sg);  // read ahead
    if (lane < RATE) x = cur;
    x = permute_warp(x, e, m, rc);
  }
  if (n_full > 0 && fill == 0) n_out = RATE;
  uint64_t* outputs = out + WIDTH + RATE;
#pragma unroll 1
  for (int k = 0; k < a.n_squeeze; k++) {
    if (fill > 0 || n_out == 0) {
      if (lane < fill) x = w;
      x = permute_warp(x, e, m, rc);
      fill = 0;
      n_out = RATE;
    }
    n_out--;
    if (lane == n_out) outputs[k] = x;
  }
  if (lane < WIDTH) out[lane] = x;
  if (lane < fill) out[WIDTH + lane] = w;
}

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

// K2t.  seg_ptr[i]: a device vector of seg_len[i] words, or 0 for words
// passed by value (taken from imm in order; their lengths sum to n_imm).
// out: [12 + 8 + n_squeeze] words (see sponge_transition_kernel).
int p2_sponge_transition(const void* state, void* out, const void* const* seg_ptr,
                         const int64_t* seg_len, int n_seg, const uint64_t* imm, int n_imm,
                         int n_out, int n_squeeze, void* stream) {
  SpongeArgs a;
  const int err = pack_sponge_args(a, seg_ptr, seg_len, n_seg, imm, n_imm, n_out, n_squeeze);
  if (err != (int)cudaSuccess) return err;
  sponge_transition_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((const uint64_t*)state,
                                                               (uint64_t*)out, a);
  return (int)cudaGetLastError();
}

}  // extern "C"
