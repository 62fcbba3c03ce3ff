"""Poseidon's partial rounds in the sparse form, with tables derived here.

The Poseidon paper's appendix B (and plonky2's `FAST_PARTIAL_*` tables)
rewrites the 22 partial rounds so that each multiplies by a sparse matrix
instead of the dense MDS.  The tables are derived from this package's own
`poseidon_constants.MDS` and `ROUND_CONSTANTS` (its Grain generator's
constants, not plonky2's), in exact integer arithmetic mod p, with column
vectors (a round maps x to M x):

  * constants move back: round k's constant c_k (k the partial rounds
    F..L) is M times M^-1 c_k, so it can be added before the previous
    round's MDS; its words 1..11 then join that round's constant (the S-box
    touches word 0 only) and its word 0 is added right after that round's
    S-box.  What is left is one full constant vector before round F
    (`FIRST_CONSTANTS`) and one scalar after each round's S-box
    (`ROUND_SCALARS`, 0 after round L);
  * the matrices split: with M written [[m00, v], [w, M^]], round k's
    matrix M_k (M for k = L, else diag(1, A_k+1) M) equals M''_k diag(1, A_k)
    with A_k = its lower-right block and M''_k = [[m00, v A_k^-1], [w_k, I]].
    diag(1, A_k) commutes with the S-box of word 0 and moves into the
    previous round's matrix; after round F it is left over as
    `INIT_MATRIX` (A_F), applied to words 1..11 once, before round F.

So the partial rounds become: x += FIRST_CONSTANTS; x[1:] = INIT_MATRIX
x[1:]; then 22 times: x0 = S(x0) + ROUND_SCALARS[k], x0' = m00 x0 +
SPARSE_ROWS[k] . x[1:], x[i]' = x[i] + SPARSE_COLS[k][i - 1] x0.  That is
23 products a round against the dense form's 144.  `permute` is the plain
PyTorch permutation in this form, the yardstick of the tables: it equals
`poseidon.permute` bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..interop import tensor_from_u64
from . import goldilocks as gl
from . import poseidon
from .poseidon_constants import FULL_ROUNDS, MDS, N_ROUNDS, PARTIAL_ROUNDS, ROUND_CONSTANTS, WIDTH

P = gl.P
HALF_FULL = FULL_ROUNDS // 2
FIRST_PARTIAL = HALF_FULL
LAST_PARTIAL = HALF_FULL + PARTIAL_ROUNDS - 1


def _matvec(m, x):
    return [sum(a * b for a, b in zip(row, x)) % P for row in m]


def _matmul(a, b):
    cols = list(zip(*b))
    return [[sum(x * y for x, y in zip(row, col)) % P for col in cols] for row in a]


def _inverse(m):
    """The inverse of a square matrix over GF(p) (Gauss-Jordan)."""
    n = len(m)
    a = [[int(v) % P for v in row] + [int(i == j) for j in range(n)] for i, row in enumerate(m)]
    for col in range(n):
        piv = next(r for r in range(col, n) if a[r][col])
        a[col], a[piv] = a[piv], a[col]
        inv = pow(a[col][col], P - 2, P)
        a[col] = [v * inv % P for v in a[col]]
        for r in range(n):
            if r != col and a[r][col]:
                f = a[r][col]
                a[r] = [(x - f * y) % P for x, y in zip(a[r], a[col])]
    return [row[n:] for row in a]


def _derive():
    mds = [[int(v) for v in row] for row in MDS]
    rc = [[int(v) for v in ROUND_CONSTANTS[r * WIDTH:(r + 1) * WIDTH]] for r in range(N_ROUNDS)]
    mds_inv = _inverse(mds)

    # constants: d_k is round k's whole constant once the later rounds'
    # constants have moved into it; u = M^-1 d_k moves to round k - 1
    scalars = [0] * PARTIAL_ROUNDS
    d = rc[LAST_PARTIAL]
    for k in range(LAST_PARTIAL, FIRST_PARTIAL, -1):
        u = _matvec(mds_inv, d)
        scalars[k - 1 - FIRST_PARTIAL] = u[0]
        d = [rc[k - 1][0]] + [(c + x) % P for c, x in zip(rc[k - 1][1:], u[1:])]
    first = d

    # matrices, from the last partial round back
    m00, v, w, m_hat = mds[0][0], mds[0][1:], [row[0] for row in mds[1:]], [row[1:] for row in mds[1:]]
    rows, cols = [None] * PARTIAL_ROUNDS, [None] * PARTIAL_ROUNDS
    a_next = None  # A_{k+1}
    for k in range(PARTIAL_ROUNDS - 1, -1, -1):
        w_k = w if a_next is None else _matvec(a_next, w)
        a_k = m_hat if a_next is None else _matmul(a_next, m_hat)
        rows[k] = _matvec(list(map(list, zip(*_inverse(a_k)))), v)  # v A_k^-1
        cols[k] = w_k
        a_next = a_k
    return m00, first, a_next, scalars, rows, cols


M00, _FIRST, _INIT, _SCALARS, _ROWS, _COLS = _derive()
FIRST_CONSTANTS = np.array(_FIRST, dtype=np.uint64)  # [12]
INIT_MATRIX = np.array(_INIT, dtype=np.uint64)  # [11, 11]: words 1..11 <- INIT_MATRIX @ words 1..11
ROUND_SCALARS = np.array(_SCALARS, dtype=np.uint64)  # [22], the last 0
SPARSE_ROWS = np.array(_ROWS, dtype=np.uint64)  # [22, 11]
SPARSE_COLS = np.array(_COLS, dtype=np.uint64)  # [22, 11]


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    return tuple(tensor_from_u64(t, device) for t in (
        ROUND_CONSTANTS.reshape(N_ROUNDS, WIDTH), FIRST_CONSTANTS, INIT_MATRIX, SPARSE_ROWS,
        SPARSE_COLS))


def _full_round(state, rc_r):
    return poseidon._mds_layer(poseidon._sbox(gl.add(state, rc_r)),
                               poseidon._tables(state.device)[1])


def _dot(x, row):
    """sum_j x[..., j] * row[j] mod p."""
    acc = gl.mul(x[..., 0], row[0])
    for j in range(1, row.shape[0]):
        acc = gl.add(acc, gl.mul(x[..., j], row[j]))
    return acc


def permute(state: torch.Tensor) -> torch.Tensor:
    """The Poseidon permutation of `[..., 12]` residue tensors with the
    partial rounds in the sparse form."""
    rc, first, init, rows, cols = _tables(state.device)
    for r in range(HALF_FULL):
        state = _full_round(state, rc[r])
    state = gl.add(state, first)
    x0, rest = state[..., 0], state[..., 1:]
    rest = torch.stack([_dot(rest, init[i]) for i in range(WIDTH - 1)], dim=-1)
    for k in range(PARTIAL_ROUNDS):
        x0 = poseidon._sbox(x0)
        if ROUND_SCALARS[k]:
            x0 = gl.add(x0, int(ROUND_SCALARS[k]))
        new0 = gl.add(gl.mul_const(x0, M00), _dot(rest, rows[k]))
        rest = gl.add(rest, gl.mul(x0[..., None], cols[k]))
        x0 = new0
    state = torch.cat([x0[..., None], rest], dim=-1)
    for r in range(HALF_FULL + PARTIAL_ROUNDS, N_ROUNDS):
        state = _full_round(state, rc[r])
    return state
