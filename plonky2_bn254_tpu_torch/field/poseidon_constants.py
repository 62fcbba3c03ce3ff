"""Poseidon parameters for Goldilocks, width 12.

The reference's forked plonky2 supplies `PoseidonGoldilocksConfig`
(SURVEY.md L0-fork surface); its hardcoded constant table is not part of the
reference repo, so we regenerate round constants with the standard Grain-LFSR
procedure from the Poseidon paper's reference implementation
(generate_parameters_grain.sage), parameterized identically to plonky2's
hash: GF(p) with p = 2^64 - 2^32 + 1, x^7 S-box, t = 12, R_F = 8, R_P = 22.

The table is data: swap `ROUND_CONSTANTS`/`MDS` for another instance's values
to obtain transcript-level compatibility with that instance.

Bit-exact-transcript descope (measured): plonky2's own hardcoded
ALL_ROUND_CONSTANTS/MDS table is not available in this build environment
(no network egress; no vendored plonky2 source on disk — checked pip
packages and the filesystem), so transcript-level parity with the Rust
reference cannot be pinned here.  Everything ABOVE the constants is
parity-tested: witness/trace layouts are bit-exact vs host mirrors
(tests/test_modular.py, test_fq_exp_trace.py), and the in-circuit
challenger replays the native transcript bit-exactly for OUR constants
(tests/test_recursion.py::test_recursive_challenger_matches_native), so
dropping in plonky2's table is a data-only swap with no code change.
"""

from __future__ import annotations

import numpy as np

from .goldilocks import P

WIDTH = 12
ALPHA = 7
FULL_ROUNDS = 8  # 4 + 4
PARTIAL_ROUNDS = 22
N_ROUNDS = FULL_ROUNDS + PARTIAL_ROUNDS  # 30
SPONGE_RATE = 8
SPONGE_CAPACITY = 4
DIGEST_LEN = 4  # field elements per hash digest (plonky2 HashOut shape)


def _grain_bits():
    """Grain LFSR bit stream per the Poseidon reference implementation."""
    bits = []

    def append(value: int, n_bits: int):
        for i in range(n_bits - 1, -1, -1):
            bits.append((value >> i) & 1)

    append(1, 2)  # field: prime
    append(0, 4)  # sbox: x^alpha
    append(64, 12)  # field size in bits
    append(WIDTH, 12)  # t
    append(FULL_ROUNDS, 10)
    append(PARTIAL_ROUNDS, 10)
    append((1 << 30) - 1, 30)  # padding ones
    state = bits[:]
    assert len(state) == 80

    def step():
        new = (
            state[62] ^ state[51] ^ state[38] ^ state[23] ^ state[13] ^ state[0]
        )
        state.pop(0)
        state.append(new)
        return new

    for _ in range(160):
        step()

    def next_bit():
        # self-shrinking: emit the 2nd bit of a pair iff the 1st is 1
        while True:
            if step() == 1:
                return step()

    while True:
        yield next_bit()


def _generate_round_constants() -> np.ndarray:
    gen = _grain_bits()
    out = np.empty(N_ROUNDS * WIDTH, dtype=np.uint64)
    count = 0
    while count < N_ROUNDS * WIDTH:
        v = 0
        for _ in range(64):
            v = (v << 1) | next(gen)
        if v < P:  # rejection sampling to the field
            out[count] = v
            count += 1
    return out


ROUND_CONSTANTS = _generate_round_constants()  # [360] uint64

# Circulant-plus-diagonal MDS in the style of plonky2's fast Goldilocks
# matrix (small entries so products stay well below 2^64 before reduction).
MDS_CIRC = [17, 15, 41, 16, 2, 28, 13, 13, 39, 18, 34, 20]
MDS_DIAG = [8] + [0] * 11


def _mds_matrix() -> np.ndarray:
    m = np.zeros((WIDTH, WIDTH), dtype=np.uint64)
    for r in range(WIDTH):
        for c in range(WIDTH):
            m[r, c] = MDS_CIRC[(c - r) % WIDTH]
        m[r, r] += MDS_DIAG[r]
    return m


MDS = _mds_matrix()


def _det_mod_p(mat) -> int:
    """Determinant over GF(p) by Gaussian elimination (sanity: MDS invertible)."""
    m = [[int(x) % P for x in row] for row in mat]
    n = len(m)
    det = 1
    for col in range(n):
        piv = next((r for r in range(col, n) if m[r][col]), None)
        if piv is None:
            return 0
        if piv != col:
            m[col], m[piv] = m[piv], m[col]
            det = P - det
        det = det * m[col][col] % P
        inv = pow(m[col][col], P - 2, P)
        for r in range(col + 1, n):
            f = m[r][col] * inv % P
            if f:
                for c in range(col, n):
                    m[r][c] = (m[r][c] - f * m[col][c]) % P
    return det


assert _det_mod_p(MDS) != 0, "Poseidon MDS matrix must be invertible over GF(p)"
