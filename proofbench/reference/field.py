"""Goldilocks, its quadratic extension and Poseidon, in plain Python and NumPy.

The benchmark's own arithmetic for judging proofs: python ints for scalars,
uint64 NumPy arrays for batches (a row per Merkle query).  Nothing here
comes from the program under test.  The Poseidon instance is the one the
prover states (width 12, rate 8, x^7, 8 full and 22 partial rounds, round
constants from the Grain LFSR of the Poseidon paper's reference script, the
circulant-plus-diagonal MDS matrix), worked out again here from those
definitions; the sponge fills a short last chunk with zeros.
"""

from __future__ import annotations

import functools

import numpy as np

P = 0xFFFFFFFF00000001
EPSILON = 0xFFFFFFFF
MULTIPLICATIVE_GROUP_GENERATOR = 7
TWO_ADICITY = 32
EXT_W = 7  # GF(p^2) = GF(p)[X] / (X^2 - 7)

WIDTH, RATE, DIGEST = 12, 8, 4
FULL_ROUNDS, PARTIAL_ROUNDS = 8, 22
N_ROUNDS = FULL_ROUNDS + PARTIAL_ROUNDS
MDS_CIRC = [17, 15, 41, 16, 2, 28, 13, 13, 39, 18, 34, 20]
MDS_DIAG = [8] + [0] * 11


def inv(a: int) -> int:
    return pow(a, P - 2, P)


def root_of_unity(n_log: int) -> int:
    """Generator of the order-2^n_log subgroup."""
    return pow(pow(MULTIPLICATIVE_GROUP_GENERATOR, (P - 1) >> TWO_ADICITY, P),
               1 << (TWO_ADICITY - n_log), P)


def bit_reverse(i: int, bits: int) -> int:
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


class Ext:
    """An element c0 + c1 X of GF(p^2), immutable."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int = 0):
        self.c0 = c0 % P
        self.c1 = c1 % P

    def __add__(self, o):
        return Ext(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Ext(self.c0 - o.c0, self.c1 - o.c1)

    def __mul__(self, o):
        return Ext(self.c0 * o.c0 + EXT_W * self.c1 * o.c1, self.c0 * o.c1 + self.c1 * o.c0)

    def __eq__(self, o):
        return isinstance(o, Ext) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __repr__(self):
        return f"Ext({self.c0:#x}, {self.c1:#x})"

    def neg(self):
        return Ext(-self.c0, -self.c1)

    def scalar_mul(self, s: int):
        return Ext(self.c0 * s, self.c1 * s)

    def is_zero(self) -> bool:
        return self.c0 == 0 and self.c1 == 0

    def inv(self):
        n = inv((self.c0 * self.c0 - EXT_W * self.c1 * self.c1) % P)
        return Ext(self.c0 * n, -self.c1 * n)

    def exp(self, e: int):
        out, base = Ext(1), self
        while e:
            if e & 1:
                out = out * base
            base = base * base
            e >>= 1
        return out


class ExtRing:
    """The constant maker the constraint code asks for (values at zeta)."""

    @staticmethod
    def const(x: int) -> Ext:
        return Ext(x)

    def zero(self) -> Ext:
        return Ext(0)

    def one(self) -> Ext:
        return Ext(1)


# ---------------------------------------------------------------------------
# Poseidon
# ---------------------------------------------------------------------------


def _grain_bits():
    """The Grain LFSR bit stream of the Poseidon paper's parameter script
    (prime field, x^alpha S-box, 64-bit field, t = 12, R_F = 8, R_P = 22)."""
    bits = []
    for value, n in ((1, 2), (0, 4), (64, 12), (WIDTH, 12), (FULL_ROUNDS, 10),
                     (PARTIAL_ROUNDS, 10), ((1 << 30) - 1, 30)):
        bits += [(value >> i) & 1 for i in range(n - 1, -1, -1)]
    state = bits

    def step():
        new = state[62] ^ state[51] ^ state[38] ^ state[23] ^ state[13] ^ state[0]
        state.pop(0)
        state.append(new)
        return new

    for _ in range(160):
        step()
    while True:
        if step() == 1:  # self-shrinking: a 1 lets the next bit out
            yield step()


@functools.lru_cache(maxsize=None)
def round_constants() -> tuple:
    """N_ROUNDS rows of WIDTH ints, rejection-sampled below p."""
    gen, out = _grain_bits(), []
    while len(out) < N_ROUNDS * WIDTH:
        v = 0
        for _ in range(64):
            v = (v << 1) | next(gen)
        if v < P:
            out.append(v)
    return tuple(tuple(out[r * WIDTH:(r + 1) * WIDTH]) for r in range(N_ROUNDS))


@functools.lru_cache(maxsize=None)
def mds() -> tuple:
    return tuple(tuple(MDS_CIRC[(c - r) % WIDTH] + (MDS_DIAG[r] if c == r else 0)
                       for c in range(WIDTH)) for r in range(WIDTH))


def permute(state) -> list:
    """The permutation on 12 python ints."""
    rc, m = round_constants(), mds()
    s = [int(x) % P for x in state]
    for r in range(N_ROUNDS):
        s = [(x + c) % P for x, c in zip(s, rc[r])]
        if r < FULL_ROUNDS // 2 or r >= FULL_ROUNDS // 2 + PARTIAL_ROUNDS:
            s = [pow(x, 7, P) for x in s]
        else:
            s[0] = pow(s[0], 7, P)
        s = [sum(a * x for a, x in zip(row, s)) % P for row in m]
    return s


# uint64 batches --------------------------------------------------------------

_U = np.uint64
_M32 = _U(0xFFFFFFFF)
_P = _U(P)
_EPS = _U(EPSILON)
_S32 = _U(32)


def reduce128(hi, lo):
    """(hi * 2^64 + lo) mod p, canonical, elementwise."""
    hh, hl = hi >> _S32, hi & _M32
    t0 = lo - hh
    t0 = np.where(lo < hh, t0 - _EPS, t0)
    t1 = hl * _EPS
    t2 = t0 + t1
    t2 = np.where(t2 < t1, t2 + _EPS, t2)
    return np.where(t2 >= _P, t2 - _P, t2)


def np_mul(a, b):
    a0, a1, b0, b1 = a & _M32, a >> _S32, b & _M32, b >> _S32
    ll, lh, hl, hh = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (ll >> _S32) + (lh & _M32) + (hl & _M32)
    lo = (ll & _M32) | (mid << _S32)
    hi = hh + (lh >> _S32) + (hl >> _S32) + (mid >> _S32)
    return reduce128(hi, lo)


def np_add(a, b):
    s = a + b
    s = np.where(s < a, s + _EPS, s)
    return np.where(s >= _P, s - _P, s)


def _sbox(x):
    x2 = np_mul(x, x)
    return np_mul(np_mul(x2, x), np_mul(x2, x2))


@functools.lru_cache(maxsize=None)
def _np_tables():
    rc = np.array(round_constants(), dtype=np.uint64)
    mds_t = np.array(mds(), dtype=np.uint64).T.copy()
    return rc, mds_t


def np_permute(state: np.ndarray) -> np.ndarray:
    """The permutation on a [B, 12] uint64 batch of canonical states."""
    rc, mds_t = _np_tables()
    s = state.astype(np.uint64, copy=True)
    half = FULL_ROUNDS // 2
    for r in range(N_ROUNDS):
        s = np_add(s, rc[r][None, :])
        if r < half or r >= half + PARTIAL_ROUNDS:
            s = _sbox(s)
        else:
            s[:, 0] = _sbox(s[:, 0])
        # small-constant MDS: split words in halves so the sums stay in 64 bits
        acc_lo = (s & _M32) @ mds_t
        acc_hi = (s >> _S32) @ mds_t
        lo = (acc_hi << _S32) + acc_lo
        hi = (acc_hi >> _S32) + (lo < acc_lo).astype(np.uint64)
        s = reduce128(hi, lo)
    return s


def canonical(a) -> np.ndarray:
    a = np.asarray(a, dtype=np.uint64)
    return np.where(a >= _P, a - _P, a)


def np_hash_no_pad(rows: np.ndarray) -> np.ndarray:
    """Sponge hash of each row of a [B, L] batch -> [B, 4] digests."""
    rows = canonical(rows)
    b, length = rows.shape
    state = np.zeros((b, WIDTH), dtype=np.uint64)
    for start in range(0, length, RATE):
        chunk = rows[:, start:start + RATE]
        state[:, :RATE] = 0
        state[:, :chunk.shape[1]] = chunk
        state = np_permute(state)
    return state[:, :DIGEST]


def np_two_to_one(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    state = np.zeros((left.shape[0], WIDTH), dtype=np.uint64)
    state[:, :DIGEST], state[:, DIGEST:2 * DIGEST] = left, right
    return np_permute(state)[:, :DIGEST]


def np_merkle_verify(digests, indices, paths, cap) -> np.ndarray:
    """Bool per row: hashing `digests` [B, 4] up `paths` [B, depth, 4] from
    leaf `indices` [B] reaches node `index >> depth` of `cap` [C, 4]."""
    cur = np.asarray(digests, dtype=np.uint64)
    idx = np.asarray(indices, dtype=np.int64)
    paths = np.asarray(paths, dtype=np.uint64)
    cap = np.asarray(cap, dtype=np.uint64)
    depth = paths.shape[1]
    node = cap[idx >> depth]
    for level in range(depth):
        sib = paths[:, level]
        right = (idx >> level & 1).astype(bool)[:, None]
        cur = np_two_to_one(np.where(right, sib, cur), np.where(right, cur, sib))
    return np.all(cur == node, axis=1)
