// Host Goldilocks + Poseidon for the PyTorch port: the sequential hashing
// that stays on the CPU.
//
// Port of the JAX package's host library (csrc/goldilocks_poseidon.cpp),
// with the same C interface.  The Fiat-Shamir challenger, the verifier's
// Merkle paths and leaf hashes, and the circuit layer's Poseidon generators
// hash a few states at a time on the host, where one call here replaces a
// permutation over python ints.  Round constants and the MDS matrix are
// installed from field/poseidon_constants.py at load time, so that module
// stays the one source of the parameters.
//
// Built with the host C++ compiler at first use by field/native.py
// (-O3 -fPIC -std=c++17, no -march=native: the library may be built on one
// host and loaded on another) into plonky2_bn254_tpu_torch/_build/, named by
// the digest of this source and the flags, and loaded with ctypes.

#include <cstdint>
#include <cstring>

using u64 = std::uint64_t;
using u128 = unsigned __int128;

namespace {

constexpr u64 P = 0xFFFFFFFF00000001ull;
constexpr int WIDTH = 12;
constexpr int N_ROUNDS = 30;
constexpr int HALF_FULL = 4;
constexpr int PARTIAL = 22;
constexpr int RATE = 8;

u64 RC[N_ROUNDS][WIDTH];
u64 MDS[WIDTH][WIDTH];

inline u64 reduce128(u128 x) {
    u64 lo = (u64)x;
    u64 hi = (u64)(x >> 64);
    u64 hi_hi = hi >> 32;
    u64 hi_lo = hi & 0xFFFFFFFFull;
    u64 t0 = lo - hi_hi;
    if (lo < hi_hi) t0 -= 0xFFFFFFFFull;  // borrow
    u64 t1 = hi_lo * 0xFFFFFFFFull;
    u64 t = t0 + t1;
    if (t < t0) t += 0xFFFFFFFFull;  // carry
    if (t >= P) t -= P;
    return t;
}

inline u64 gl_mul(u64 a, u64 b) { return reduce128((u128)a * b); }

// a + b mod p for any u64 a and canonical b (the round constants).
inline u64 gl_add(u64 a, u64 b) {
    u64 s = a + b;
    if (s < a) s += 0xFFFFFFFFull;
    if (s >= P) s -= P;
    return s;
}

inline u64 sbox7(u64 x) {
    u64 x2 = gl_mul(x, x);
    u64 x4 = gl_mul(x2, x2);
    u64 x6 = gl_mul(x4, x2);
    return gl_mul(x6, x);
}

void mds_layer(u64 state[WIDTH]) {
    u64 out[WIDTH];
    for (int r = 0; r < WIDTH; ++r) {
        // entries are < 64: accumulate the full sum in u128, reduce once
        u128 acc = 0;
        for (int j = 0; j < WIDTH; ++j) acc += (u128)MDS[r][j] * state[j];
        out[r] = reduce128(acc);
    }
    std::memcpy(state, out, sizeof(out));
}

void permute_one(u64 state[WIDTH]) {
    int r = 0;
    for (int k = 0; k < HALF_FULL; ++k, ++r) {
        for (int i = 0; i < WIDTH; ++i) state[i] = sbox7(gl_add(state[i], RC[r][i]));
        mds_layer(state);
    }
    for (int k = 0; k < PARTIAL; ++k, ++r) {
        for (int i = 0; i < WIDTH; ++i) state[i] = gl_add(state[i], RC[r][i]);
        state[0] = sbox7(state[0]);
        mds_layer(state);
    }
    for (int k = 0; k < HALF_FULL; ++k, ++r) {
        for (int i = 0; i < WIDTH; ++i) state[i] = sbox7(gl_add(state[i], RC[r][i]));
        mds_layer(state);
    }
}

}  // namespace

extern "C" {

// Install constants: rc is [30*12] row-major, mds is [12*12] row-major.
void gl_poseidon_init(const u64 *rc, const u64 *mds) {
    std::memcpy(RC, rc, sizeof(RC));
    std::memcpy(MDS, mds, sizeof(MDS));
}

void gl_poseidon_permute(u64 *state) { permute_one(state); }

// Sponge hash (overwrite absorption, zero-padded final chunk): n inputs
// -> 4-element digest.
void gl_poseidon_hash_no_pad(const u64 *inputs, int n, u64 *digest) {
    u64 state[WIDTH] = {0};
    for (int start = 0; start < n; start += RATE) {
        for (int i = 0; i < RATE; ++i) {
            int idx = start + i;
            state[i] = idx < n ? inputs[idx] : 0;
        }
        permute_one(state);
    }
    std::memcpy(digest, state, 4 * sizeof(u64));
}

// Merkle two-to-one compression of 4-element digests.
void gl_poseidon_two_to_one(const u64 *left, const u64 *right, u64 *out) {
    u64 state[WIDTH] = {0};
    std::memcpy(state, left, 4 * sizeof(u64));
    std::memcpy(state + 4, right, 4 * sizeof(u64));
    permute_one(state);
    std::memcpy(out, state, 4 * sizeof(u64));
}

// Verify a Merkle path: digest (4), leaf index, path (n_path x 4 siblings),
// expected cap node (4, at index >> n_path within the cap).  Returns 1/0.
int gl_poseidon_verify_path(const u64 *digest, u64 index, const u64 *path,
                            int n_path, const u64 *cap_node) {
    u64 h[4];
    std::memcpy(h, digest, sizeof(h));
    for (int i = 0; i < n_path; ++i) {
        u64 out[4];
        if (index & 1)
            gl_poseidon_two_to_one(path + 4 * i, h, out);
        else
            gl_poseidon_two_to_one(h, path + 4 * i, out);
        std::memcpy(h, out, sizeof(h));
        index >>= 1;
    }
    return std::memcmp(h, cap_node, sizeof(h)) == 0 ? 1 : 0;
}

}  // extern "C"
