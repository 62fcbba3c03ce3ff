"""Poseidon permutation + sponge over Goldilocks on torch tensors.

Port of `plonky2_bn254_tpu/field/poseidon.py`.  The tensor flavor works on
`[..., 12]` int64 residue tensors and is the plain version of the hand
kernels in `poseidon_cuda.py`.  The host flavor over python ints backs the
sequential challenger, the verifier and the circuit's Poseidon generators:
`h_permute`, `h_hash_no_pad` and `h_two_to_one` call the native library
(`native.py`); their pure-python bodies stay as `h_*_plain`, for the tests.
"""

from __future__ import annotations

import functools

import torch

from ..interop import tensor_from_u64
from . import goldilocks as gl
from . import native
from .poseidon_constants import (
    ALPHA,
    DIGEST_LEN,
    FULL_ROUNDS,
    MDS,
    N_ROUNDS,
    PARTIAL_ROUNDS,
    ROUND_CONSTANTS,
    SPONGE_RATE,
    WIDTH,
)

_HALF_FULL = FULL_ROUNDS // 2

_MDS_INT = [[int(x) for x in row] for row in MDS]
_RC = ROUND_CONSTANTS.reshape(N_ROUNDS, WIDTH)
_RC_INT = [[int(x) for x in row] for row in _RC]


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """(round constants [30, 12], MDS [12, 12]) as int64 tensors on `device`."""
    rc = tensor_from_u64(_RC, device)
    mds = torch.tensor(_MDS_INT, dtype=torch.int64, device=device)
    return rc, mds


def _sbox(x):
    x2 = gl.square(x)
    x4 = gl.square(x2)
    x6 = gl.mul(x4, x2)
    return gl.mul(x6, x)


def _mds_layer(state, mds):
    """MDS @ state along the last axis: the exact 128-bit row sums (entries
    < 64, so 32-bit halves times entries sum below 2^42), one reduction
    per output."""
    x_lo = state & 0xFFFFFFFF
    x_hi = gl._shr32(state)
    acc_lo = (x_lo[..., None, :] * mds).sum(-1)
    acc_hi = (x_hi[..., None, :] * mds).sum(-1)
    lo = acc_lo + ((acc_hi & 0xFFFFFFFF) << 32)
    hi = gl._shr32(acc_hi) + gl._ult(lo, acc_lo)
    return gl._reduce128(hi, lo)


def permute(state: torch.Tensor) -> torch.Tensor:
    """Poseidon permutation on `[..., 12]` residue tensors."""
    rc, mds = _tables(state.device)

    def full_round(r, state):
        state = _sbox(gl.add(state, rc[r]))
        return _mds_layer(state, mds)

    def partial_round(r, state):
        state = gl.add(state, rc[r])
        state = torch.cat([_sbox(state[..., 0:1]), state[..., 1:]], dim=-1)
        return _mds_layer(state, mds)

    for r in range(_HALF_FULL):
        state = full_round(r, state)
    for r in range(_HALF_FULL, _HALF_FULL + PARTIAL_ROUNDS):
        state = partial_round(r, state)
    for r in range(_HALF_FULL + PARTIAL_ROUNDS, N_ROUNDS):
        state = full_round(r, state)
    return state


def hash_no_pad(inputs: torch.Tensor) -> torch.Tensor:
    """Sponge hash of `[..., n]` inputs -> `[..., 4]` digests.

    Overwrite-mode absorption in rate-8 chunks, zero-padded final chunk,
    zero initial capacity (plonky2's `hash_n_to_m_no_pad` shape).
    """
    n = inputs.shape[-1]
    batch = inputs.shape[:-1]
    n_chunks = -(-n // SPONGE_RATE)
    pad = n_chunks * SPONGE_RATE - n
    if pad:
        inputs = torch.cat(
            [inputs, inputs.new_zeros(batch + (pad,))], dim=-1
        )
    state = inputs.new_zeros(batch + (WIDTH,))
    for i in range(n_chunks):
        chunk = inputs[..., i * SPONGE_RATE : (i + 1) * SPONGE_RATE]
        state = permute(torch.cat([chunk, state[..., SPONGE_RATE:]], dim=-1))
    return state[..., :DIGEST_LEN]


def two_to_one(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Merkle node compression: two `[..., 4]` digests -> `[..., 4]`."""
    cap = left.new_zeros(left.shape[:-1] + (WIDTH - 2 * DIGEST_LEN,))
    return permute(torch.cat([left, right, cap], dim=-1))[..., :DIGEST_LEN]


# ---------------------------------------------------------------------------
# Host scalar flavor (python ints) — challenger / verifier / circuit
# ---------------------------------------------------------------------------


def h_permute(state):
    """Permutation on a list of 12 python ints (the native library)."""
    return native.permute(state)


def h_hash_no_pad(inputs):
    """Sponge hash of a python-int list -> 4-int digest (the native library)."""
    return native.hash_no_pad(inputs)


def h_two_to_one(left, right):
    """Merkle compression of two 4-int digests (the native library)."""
    return native.two_to_one(left, right)


def h_permute_plain(state):
    """Permutation on a list of 12 python ints, in python."""
    assert len(state) == WIDTH
    p = gl.P
    state = [s % p for s in state]
    mds = _MDS_INT

    def mds_layer(s):
        return [sum(m * x for m, x in zip(row, s)) % p for row in mds]

    r = 0
    for _ in range(_HALF_FULL):
        state = [pow(s + c, ALPHA, p) for s, c in zip(state, _RC_INT[r])]
        state = mds_layer(state)
        r += 1
    for _ in range(PARTIAL_ROUNDS):
        state = [(s + c) % p for s, c in zip(state, _RC_INT[r])]
        state[0] = pow(state[0], ALPHA, p)
        state = mds_layer(state)
        r += 1
    for _ in range(_HALF_FULL):
        state = [pow(s + c, ALPHA, p) for s, c in zip(state, _RC_INT[r])]
        state = mds_layer(state)
        r += 1
    return state


def h_hash_no_pad_plain(inputs):
    """Sponge hash of a python-int list -> 4-int digest, in python."""
    state = [0] * WIDTH
    for start in range(0, len(inputs), SPONGE_RATE):
        chunk = [int(v) for v in inputs[start : start + SPONGE_RATE]]
        chunk += [0] * (SPONGE_RATE - len(chunk))
        state = h_permute_plain(chunk + state[SPONGE_RATE:])
    return state[:DIGEST_LEN]


def h_two_to_one_plain(left, right):
    """Merkle compression of two 4-int digests, in python."""
    state = [int(v) for v in left] + [int(v) for v in right]
    return h_permute_plain(state + [0] * (WIDTH - 2 * DIGEST_LEN))[:DIGEST_LEN]
