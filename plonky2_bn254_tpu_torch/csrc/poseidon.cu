// Poseidon over Goldilocks (width 12, rate 8, x^7 S-box, 8 full + 22 partial
// rounds) as hand-written CUDA kernels for Hopper (sm_90a).
//
// K1 p2_hash_leaves replaces plonky2_bn254_tpu/field/poseidon_pallas.py
//    _leaf_hash_fn (body _make_leaf_kernel): the overwrite-mode sponge of
//    every row of an [N, W] leaf matrix -> [N, 4] digests.
// K1m p2_tree_levels is K1's Merkle use (the reference runs its Merkle
//    levels through the same Pallas kernel on [m, 8] pair rows, since
//    two_to_one(l, r) == hash_no_pad(l || r)): every level of a tree below
//    the regime threshold in one launch.
// K2 p2_permute_states replaces poseidon_pallas.py _permute_states_fn: the
//    raw permutation of [N, 12] states, for the FRI proof-of-work grind.
// K2t p2_sponge_transition: one whole Fiat-Shamir transcript transition on
//    one sponge state (absorb, then squeeze); see the note at its kernel.
//
// K1 and K2 run in one of two regimes, which the wrapper picks from the
// row count, the SM count and the throughput kernels' occupancy
// (field/poseidon_cuda.py regime):
//
// Throughput (rows that fill the card): bound by the integer issue rate.
//   One permutation is ~470 Goldilocks products plus the MDS layers; a row
//   of the 781-wide trace runs 98 permutations over 6.2 KB, ~40 integer
//   ops per input byte, far above the card's ops-per-byte balance.  Design:
//   one thread per row, the 12-word state in registers, the partial rounds
//   in the sparse form (field/poseidon_sparse.py: 23 full products a round
//   instead of the dense MDS's 144 small ones; the products of a row summed
//   exactly in 160 bits and reduced once), each full round's next constant
//   folded into its MDS sum.  Tables sit in __constant__ memory, read
//   uniformly by the warp.  __launch_bounds__(128, 2) leaves ptxas ~200
//   registers for the fully unrolled rounds: capping it at 128 (4 blocks
//   an SM) ran slower, more warps hiding less than the lost scheduling
//   freedom cost (scripts/torch_poseidon_regimes.py).  Any N >= 1 and any
//   W (W = 0 too) are taken.
//
// Latency (fewer rows): bound by one permutation's critical path per
//   absorbed chunk; with one thread a row a launch costs the ~70 us one
//   thread takes for a permutation, whatever its size.  Design: K2t's warp
//   core on groups of 16 lanes, two states a warp: lane e < 12 holds word
//   e, so a round's S-boxes run side by side and the MDS sums are trees
//   over shuffled words; the partial rounds stay dense, as in K2t, since
//   the sparse form's full products would lengthen the path.  Round
//   constants sit in shared memory, each folded into the previous round's
//   MDS sum.
//
// K1m: each block of 256 threads hashes 16 pair rows of the first level
//   and walks its subtree down through shared memory to one root; the last
//   of each 32 sibling blocks to finish (a counter and __threadfence)
//   carries on from their roots, and so on up.  So a tree costs one launch,
//   each level one pass of a block (about one permutation latency) once
//   its rows no longer fill the card.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

// The throughput kernels' minimum resident blocks an SM (__launch_bounds__;
// scripts/torch_poseidon_regimes.py builds other values to compare).
#ifndef P2_TP_MIN_BLOCKS
#define P2_TP_MIN_BLOCKS 2
#endif

namespace {

constexpr int WIDTH = 12;
constexpr int RATE = 8;
constexpr int HALF_FULL = 4;
constexpr int PARTIAL = 22;
constexpr int N_ROUNDS = 2 * HALF_FULL + PARTIAL;
constexpr int N_FULL = 2 * HALF_FULL;

__constant__ uint64_t c_rc[N_ROUNDS * WIDTH];
__constant__ uint32_t c_mds[WIDTH * WIDTH];
// the sparse partial rounds (field/poseidon_sparse.py): the constant each
// full round's MDS sum folds in (the next round's, or the first partial
// round's whole vector), the 11 x 11 initial matrix, the scalar after each
// partial S-box, each round's first row [m00, SPARSE_ROWS[k]] and column
__constant__ uint64_t c_full_next[N_FULL * WIDTH];
__constant__ uint64_t c_init[(WIDTH - 1) * (WIDTH - 1)];
__constant__ uint64_t c_scalar[PARTIAL];
__constant__ uint64_t c_row[PARTIAL * WIDTH];
__constant__ uint64_t c_col[PARTIAL * (WIDTH - 1)];

// ---------------------------------------------------------------------------
// One permutation in one thread's registers (throughput regime)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  const uint64_t x2 = gl::mul(x, x);
  const uint64_t x4 = gl::mul(x2, x2);
  const uint64_t x6 = gl::mul(x4, x2);
  return gl::mul(x6, x);
}

// MDS @ state + full round f's folded constant: exact 128-bit row sums from
// 32-bit halves times the small entries (each half-sum < 2^42), then one
// reduction per output.
__device__ __forceinline__ void mds_layer(uint64_t s[WIDTH], int f) {
  uint64_t out[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; i++) {
    const uint64_t k = c_full_next[f * WIDTH + i];
    uint64_t acc_lo = k & 0xFFFFFFFFull, acc_hi = k >> 32;
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

// Full round f (0..7), its round constant already added.
__device__ __forceinline__ void full_round(uint64_t s[WIDTH], int f) {
#pragma unroll
  for (int e = 0; e < WIDTH; e++) s[e] = sbox(s[e]);
  mds_layer(s, f);
}

// (top, hi, lo) += a * b: the exact 128-bit product into a 160-bit sum.
__device__ __forceinline__ void mac160(uint64_t& lo, uint64_t& hi, uint32_t& top, uint64_t a,
                                       uint64_t b) {
  asm("{\n\t"
      ".reg .u32 a0, a1, b0, b1, c0, c1, c2, c3;\n\t"
      "mov.b64 {a0, a1}, %3;\n\t"
      "mov.b64 {b0, b1}, %4;\n\t"
      "mov.b64 {c0, c1}, %0;\n\t"
      "mov.b64 {c2, c3}, %1;\n\t"
      "mad.lo.cc.u32 c0, a0, b0, c0;\n\t"
      "madc.hi.cc.u32 c1, a0, b0, c1;\n\t"
      "madc.lo.cc.u32 c2, a1, b1, c2;\n\t"
      "madc.hi.cc.u32 c3, a1, b1, c3;\n\t"
      "addc.u32 %2, %2, 0;\n\t"
      "mad.lo.cc.u32 c1, a0, b1, c1;\n\t"
      "madc.hi.cc.u32 c2, a0, b1, c2;\n\t"
      "addc.cc.u32 c3, c3, 0;\n\t"
      "addc.u32 %2, %2, 0;\n\t"
      "mad.lo.cc.u32 c1, a1, b0, c1;\n\t"
      "madc.hi.cc.u32 c2, a1, b0, c2;\n\t"
      "addc.cc.u32 c3, c3, 0;\n\t"
      "addc.u32 %2, %2, 0;\n\t"
      "mov.b64 %0, {c0, c1};\n\t"
      "mov.b64 %1, {c2, c3};\n\t"
      "}"
      : "+l"(lo), "+l"(hi), "+r"(top)
      : "l"(a), "l"(b));
}

// top * 2^128 + hi * 2^64 + lo mod p, canonical, for top < 2^32:
// 2^128 = -2^32 (mod p).
__device__ __forceinline__ uint64_t reduce160(uint64_t lo, uint64_t hi, uint32_t top) {
  return gl::sub(gl::reduce128(hi, lo), (uint64_t)top << 32);
}

// a * b + c mod p, canonical (the sum is below 2^128).
__device__ __forceinline__ uint64_t mul_add(uint64_t a, uint64_t b, uint64_t c) {
  uint64_t lo, hi;
  asm("{\n\t"
      ".reg .u32 a0, a1, b0, b1, c0, c1, c2, c3;\n\t"
      "mov.b64 {a0, a1}, %2;\n\t"
      "mov.b64 {b0, b1}, %3;\n\t"
      "mov.b64 {c0, c1}, %4;\n\t"
      "mad.lo.cc.u32 c0, a0, b0, c0;\n\t"
      "madc.hi.cc.u32 c1, a0, b0, c1;\n\t"
      "madc.lo.cc.u32 c2, a1, b1, 0;\n\t"
      "madc.hi.u32 c3, a1, b1, 0;\n\t"
      "mad.lo.cc.u32 c1, a0, b1, c1;\n\t"
      "madc.hi.cc.u32 c2, a0, b1, c2;\n\t"
      "addc.u32 c3, c3, 0;\n\t"
      "mad.lo.cc.u32 c1, a1, b0, c1;\n\t"
      "madc.hi.cc.u32 c2, a1, b0, c2;\n\t"
      "addc.u32 c3, c3, 0;\n\t"
      "mov.b64 %0, {c0, c1};\n\t"
      "mov.b64 %1, {c2, c3};\n\t"
      "}"
      : "=l"(lo), "=l"(hi)
      : "l"(a), "l"(b), "l"(c));
  return gl::reduce128(hi, lo);
}

// Words 1..11 <- the initial matrix times words 1..11 (before the first
// partial round; its constant vector already added).
__device__ __forceinline__ void init_layer(uint64_t s[WIDTH]) {
  uint64_t t[WIDTH - 1];
#pragma unroll
  for (int i = 0; i < WIDTH - 1; i++) {
    uint64_t lo = 0, hi = 0;
    uint32_t top = 0;
#pragma unroll
    for (int j = 0; j < WIDTH - 1; j++) mac160(lo, hi, top, s[1 + j], c_init[i * (WIDTH - 1) + j]);
    t[i] = reduce160(lo, hi, top);
  }
#pragma unroll
  for (int i = 0; i < WIDTH - 1; i++) s[1 + i] = t[i];
}

// Sparse partial round k: x0 = S(x0) + scalar; x0' = row . x; x_i' = x_i +
// col_i x0.
__device__ __forceinline__ void sparse_round(uint64_t s[WIDTH], int k) {
  const uint64_t x0 = gl::add(sbox(s[0]), c_scalar[k]);
  uint64_t lo = 0, hi = 0;
  uint32_t top = 0;
  mac160(lo, hi, top, x0, c_row[k * WIDTH]);
#pragma unroll
  for (int j = 1; j < WIDTH; j++) mac160(lo, hi, top, s[j], c_row[k * WIDTH + j]);
#pragma unroll
  for (int i = 1; i < WIDTH; i++) s[i] = mul_add(x0, c_col[k * (WIDTH - 1) + i - 1], s[i]);
  s[0] = reduce160(lo, hi, top);
}

__device__ void permute(uint64_t s[WIDTH]) {
#pragma unroll
  for (int e = 0; e < WIDTH; e++) s[e] = gl::add(s[e], c_rc[e]);
#pragma unroll 1
  for (int f = 0; f < HALF_FULL; f++) full_round(s, f);
  init_layer(s);
#pragma unroll 1
  for (int k = 0; k < PARTIAL; k++) sparse_round(s, k);
#pragma unroll
  for (int e = 0; e < WIDTH; e++) s[e] = gl::add(s[e], c_rc[(HALF_FULL + PARTIAL) * WIDTH + e]);
#pragma unroll 1
  for (int f = HALF_FULL; f < N_FULL; f++) full_round(s, f);
}

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS, P2_TP_MIN_BLOCKS)
    hash_leaves_kernel(const uint64_t* __restrict__ leaves, uint64_t* __restrict__ out, int64_t n,
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

__global__ void __launch_bounds__(THREADS, P2_TP_MIN_BLOCKS)
    permute_states_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, int64_t n) {
  const int64_t row = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (row >= n) return;
  uint64_t s[WIDTH];
#pragma unroll
  for (int e = 0; e < WIDTH; e++) s[e] = in[row * WIDTH + e];
  permute(s);
#pragma unroll
  for (int e = 0; e < WIDTH; e++) out[row * WIDTH + e] = s[e];
}

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
// a tree into two exact 64-bit sums of 32-bit halves (each < 2^42).  W: the
// lanes that hold one state (K2t: the warp; the latency kernels: 16).
template <int J0, int W = 32>
__device__ __forceinline__ void mds_sum(uint64_t x, const uint32_t m[WIDTH], uint64_t k,
                                        uint64_t& sum_lo, uint64_t& sum_hi) {
  uint64_t plo[WIDTH], phi[WIDTH];
#pragma unroll
  for (int j = J0; j < WIDTH; j++) {
    const uint32_t lo = __shfl_sync(FULL_MASK, (uint32_t)x, j, W);
    const uint32_t hi = __shfl_sync(FULL_MASK, (uint32_t)(x >> 32), j, W);
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
template <int W = 32>
__device__ __forceinline__ uint64_t full_round_warp(uint64_t x, const uint32_t m[WIDTH],
                                                    uint64_t k) {
  uint64_t lo, hi;
  mds_sum<0, W>(sbox3(x), m, k, lo, hi);
  return mds_finish(lo, hi);
}

template <int W = 32>
__device__ __forceinline__ uint64_t partial_round_warp(uint64_t x, const uint32_t m[WIDTH],
                                                       uint64_t k) {
  const uint32_t x0_lo = __shfl_sync(FULL_MASK, (uint32_t)x, 0, W);
  const uint32_t x0_hi = __shfl_sync(FULL_MASK, (uint32_t)(x >> 32), 0, W);
  uint64_t lo, hi;
  mds_sum<1, W>(x, m, k, lo, hi);
  const uint64_t t = sbox3(((uint64_t)x0_hi << 32) | x0_lo);
  lo += (t & 0xFFFFFFFFull) * m[0];
  hi += (t >> 32) * m[0];
  return mds_finish(lo, hi);
}

__device__ __forceinline__ uint64_t next_constant(const uint64_t* rc, int r, int e) {
  return r + 1 < N_ROUNDS ? rc[(r + 1) * WIDTH + e] : 0ull;
}

// The permutation with the state spread over the warp (lane e holds word
// e; e is 0 on lanes 12..31), or over each group of W lanes (lane e of its
// group; e is 0 on lanes 12..W-1).  rc: the round constants in shared
// memory.
template <int W = 32>
__device__ __forceinline__ uint64_t permute_warp(uint64_t x, int e, const uint32_t m[WIDTH],
                                                 const uint64_t* rc) {
  x = gl::add(x, rc[e]);
  int r = 0;
#pragma unroll 1
  for (; r < HALF_FULL; r++) x = full_round_warp<W>(x, m, next_constant(rc, r, e));
#pragma unroll 1
  for (; r < HALF_FULL + PARTIAL; r++) x = partial_round_warp<W>(x, m, next_constant(rc, r, e));
#pragma unroll 1
  for (; r < N_ROUNDS; r++) x = full_round_warp<W>(x, m, next_constant(rc, r, e));
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

// ---------------------------------------------------------------------------
// One permutation on a group of 16 lanes (latency regime: K1 and K2 below
// the threshold, K1m): K2t's warp core with width-16 shuffles, two states
// a warp.  Lane e < 12 of a group holds state word e; lanes 12..15 take
// part in the shuffles only.
// ---------------------------------------------------------------------------

constexpr int GROUP = 16;                // lanes that hold one state
constexpr int GROUPS = THREADS / GROUP;  // states a 128-thread block holds
// at most 64 registers (K2t's core takes 64): 8 blocks, 32 warps an SM
constexpr int LATENCY_MIN_BLOCKS = 8;

// The round constants into shared memory, and this lane's word e and MDS
// row.
__device__ __forceinline__ int setup_group(uint64_t* rc, uint32_t m[WIDTH]) {
  for (int i = threadIdx.x; i < N_ROUNDS * WIDTH; i += blockDim.x) rc[i] = c_rc[i];
  const int lane = threadIdx.x % GROUP;
  const int e = lane < WIDTH ? lane : 0;
#pragma unroll
  for (int j = 0; j < WIDTH; j++) m[j] = c_mds[e * WIDTH + j];
  __syncthreads();
  return e;
}

__global__ void __launch_bounds__(THREADS, LATENCY_MIN_BLOCKS)
    hash_leaves_group_kernel(const uint64_t* __restrict__ leaves, uint64_t* __restrict__ out,
                             int64_t n, int64_t w) {
  __shared__ uint64_t rc[N_ROUNDS * WIDTH];
  uint32_t m[WIDTH];
  const int e = setup_group(rc, m);
  const int lane = threadIdx.x % GROUP;
  const int64_t row = blockIdx.x * (int64_t)GROUPS + threadIdx.x / GROUP;
  if (blockIdx.x * (int64_t)GROUPS + (threadIdx.x / 32) * (32 / GROUP) >= n) return;  // the warp
  const bool live = row < n;
  const uint64_t* src = leaves + (live ? row * w : 0);
  // next: on lanes 0..7, the word of the chunk to come (read ahead)
  uint64_t x = 0, next = live && lane < RATE && lane < w ? src[lane] : 0ull;
#pragma unroll 1
  for (int64_t c = 0; c < w; c += RATE) {
    const uint64_t cur = next;
    const int64_t q = c + RATE + lane;
    next = live && lane < RATE && q < w ? src[q] : 0ull;
    if (lane < RATE) x = cur;
    x = permute_warp<GROUP>(x, e, m, rc);
  }
  if (live && lane < 4) out[row * 4 + lane] = x;
}

__global__ void __launch_bounds__(THREADS, LATENCY_MIN_BLOCKS)
    permute_states_group_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                                int64_t n) {
  __shared__ uint64_t rc[N_ROUNDS * WIDTH];
  uint32_t m[WIDTH];
  const int e = setup_group(rc, m);
  const int lane = threadIdx.x % GROUP;
  const int64_t row = blockIdx.x * (int64_t)GROUPS + threadIdx.x / GROUP;
  if (blockIdx.x * (int64_t)GROUPS + (threadIdx.x / 32) * (32 / GROUP) >= n) return;  // the warp
  const bool live = row < n && lane < WIDTH;
  uint64_t x = live ? in[row * WIDTH + lane] : 0ull;
  x = permute_warp<GROUP>(x, e, m, rc);
  if (live) out[row * WIDTH + lane] = x;
}

unsigned group_blocks_for(int64_t n) { return (unsigned)((n + GROUPS - 1) / GROUPS); }

// ---------------------------------------------------------------------------
// K1m: the Merkle levels above n digests, n_levels of them, in one launch.
// Level l has n >> (l + 1) rows, row i the hash of digests 2i and 2i + 1 of
// the level below (one 8-word chunk, zero capacity); the levels lie one
// after another in out, level 0 first.
// ---------------------------------------------------------------------------

constexpr int TREE_THREADS = 256;
constexpr int TREE_ROWS = TREE_THREADS / GROUP;  // 16: a block's rows at a stage's first level
constexpr int TREE_DEPTH = 5;                    // levels a stage walks: 16, 8, 4, 2, 1 rows
constexpr int TREE_FANIN = 2 * TREE_ROWS;        // blocks whose roots feed one block of the next stage

// Hashes pair rows [0, rows) of src (8 words a row; rows <= TREE_ROWS) into
// dst and dst2 (4 words a row); `ldcg`: read src through L2 only (words
// other blocks wrote).  Every thread of the block calls it.
__device__ __forceinline__ void hash_pairs(const uint64_t* src, uint64_t* dst, uint64_t* dst2,
                                           int64_t rows, bool ldcg, int e, const uint32_t m[WIDTH],
                                           const uint64_t* rc) {
  const int lane = threadIdx.x % GROUP;
  const int row = threadIdx.x / GROUP;
  uint64_t x = 0;
  if (row < rows && lane < RATE) {
    const uint64_t* a = src + row * RATE + lane;
    x = ldcg ? __ldcg((const unsigned long long*)a) : *a;
  }
  __syncthreads();  // every input read before any output (src may alias dst) is written
  if ((threadIdx.x / 32) * (32 / GROUP) < rows) {  // the warp has a row
    x = permute_warp<GROUP>(x, e, m, rc);
    if (row < rows && lane < 4) {
      dst[row * 4 + lane] = x;
      dst2[row * 4 + lane] = x;
    }
  }
  __syncthreads();
}

// In stages: at a stage's first level l, node b (block b at stage 0) owns
// rows [16 b, 16 b + 16) and hashes them and the 4 levels below them down
// to one root, through shared memory; then the last of each 32 sibling
// nodes to finish (a counter each, and __threadfence) carries on as node
// b / 32 of the next stage, reading their roots back.  A level is one pass
// of one block wherever it lies, so a tree's critical path is one
// permutation a level.  counters: zero, one for each group of each stage.
__global__ void __launch_bounds__(TREE_THREADS)
    tree_levels_kernel(const uint64_t* __restrict__ digests, uint64_t* __restrict__ out, int64_t n,
                       int n_levels, unsigned* __restrict__ counters) {
  __shared__ uint64_t rc[N_ROUNDS * WIDTH];
  __shared__ uint64_t level[TREE_ROWS * 4];
  __shared__ bool last;
  uint32_t m[WIDTH];
  const int e = setup_group(rc, m);
  const int64_t rows0 = n >> 1;
  int64_t node = blockIdx.x, nodes = gridDim.x;
  int64_t off = 0;  // the first row of level l in out
  const uint64_t* src = digests;  // the level below the stage's first (pair rows)
  bool ldcg = false;
  unsigned* group_counters = counters;
  int l = 0;
  for (;;) {
    for (int d = 0; d < TREE_DEPTH && l < n_levels; d++, l++) {
      const int64_t rows = rows0 >> l, per = TREE_ROWS >> d, base = node * per;
      const int64_t here = per < rows - base ? per : rows - base;
      hash_pairs(d == 0 ? src + base * RATE : level, level, out + (off + base) * 4, here,
                 d == 0 && ldcg, e, m, rc);
      off += rows;
    }
    if (l == n_levels) return;
    const int64_t group = node / TREE_FANIN;
    const int64_t members = nodes - group * TREE_FANIN < TREE_FANIN ? nodes - group * TREE_FANIN
                                                                    : TREE_FANIN;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(group_counters + group, 1u) == members - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    group_counters += (nodes + TREE_FANIN - 1) / TREE_FANIN;
    nodes = (nodes + TREE_FANIN - 1) / TREE_FANIN;
    node = group;
    src = out + (off - (rows0 >> (l - 1))) * 4;
    ldcg = true;
  }
}

}  // namespace

extern "C" {

// Installs the tables on the current device; the host owns and derives them
// (poseidon_constants.py, poseidon_sparse.py, poseidon_cuda.py): the round
// constants [30 * 12], the MDS matrix [12 * 12], the constants folded into
// each full round's MDS sum [8 * 12], and the sparse partial rounds' initial
// matrix [11 * 11], scalars [22], rows [22 * 12] and columns [22 * 11].
int p2_poseidon_init(const uint64_t* rc, const uint32_t* mds, const uint64_t* full_next,
                     const uint64_t* init, const uint64_t* scalar, const uint64_t* row,
                     const uint64_t* col) {
  cudaMemcpyToSymbol(c_rc, rc, sizeof(c_rc));
  cudaMemcpyToSymbol(c_mds, mds, sizeof(c_mds));
  cudaMemcpyToSymbol(c_full_next, full_next, sizeof(c_full_next));
  cudaMemcpyToSymbol(c_init, init, sizeof(c_init));
  cudaMemcpyToSymbol(c_scalar, scalar, sizeof(c_scalar));
  cudaMemcpyToSymbol(c_row, row, sizeof(c_row));
  cudaMemcpyToSymbol(c_col, col, sizeof(c_col));
  return (int)cudaGetLastError();
}

// The blocks of 128 threads an SM holds of the throughput kernels:
// blocks[0] K1's, blocks[1] K2's.
int p2_poseidon_occupancy(int* blocks) {
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks[0], hash_leaves_kernel,
                                                                  THREADS, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks[1], permute_states_kernel,
                                                        THREADS, 0);
  return (int)err;
}

// K1; regime 0: throughput, 1: latency.
int p2_hash_leaves(const void* leaves, void* out, int64_t n, int64_t w, int regime, void* stream) {
  if (regime == 0)
    hash_leaves_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)leaves, (uint64_t*)out, n, w);
  else
    hash_leaves_group_kernel<<<group_blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)leaves, (uint64_t*)out, n, w);
  return (int)cudaGetLastError();
}

// K2; regime as for K1.
int p2_permute_states(const void* in, void* out, int64_t n, int regime, void* stream) {
  if (regime == 0)
    permute_states_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)in, (uint64_t*)out, n);
  else
    permute_states_group_kernel<<<group_blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)in, (uint64_t*)out, n);
  return (int)cudaGetLastError();
}

// The words of zeroed counters p2_tree_levels needs for n digests.
int64_t p2_tree_counters(int64_t n) {
  int64_t nodes = ((n >> 1) + TREE_ROWS - 1) / TREE_ROWS, total = 0;
  while (nodes > 1) {
    nodes = (nodes + TREE_FANIN - 1) / TREE_FANIN;
    total += nodes;
  }
  return total + 1;
}

// K1m.  digests: [n, 4], n a multiple of 2^n_levels (n_levels >= 1); out:
// the levels, [n - n / 2^n_levels, 4]; counters: p2_tree_counters(n) words,
// 0 at the launch.
int p2_tree_levels(const void* digests, void* out, int64_t n, int n_levels, void* counters,
                   void* stream) {
  if (n_levels < 1 || n % (2LL << (n_levels - 1)) != 0) return (int)cudaErrorInvalidValue;
  const int64_t rows0 = n >> 1;
  const unsigned blocks = (unsigned)((rows0 + TREE_ROWS - 1) / TREE_ROWS);
  tree_levels_kernel<<<blocks, TREE_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)digests, (uint64_t*)out, n, n_levels, (unsigned*)counters);
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
