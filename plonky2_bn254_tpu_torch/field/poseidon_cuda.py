"""Poseidon kernels K1 (leaf sponge), K1m (Merkle levels), K2 (raw
permutation) and K2t (one transcript transition) for the H100.

Port of `plonky2_bn254_tpu/field/poseidon_pallas.py` (`hash_leaves`,
`permute_states`); K1m runs the Merkle levels that the reference runs
through the same Pallas kernel on `[m, 8]` pair rows
(`plonky2_bn254_tpu/prover/merkle.py`); K2t runs the device Fiat–Shamir
transcript (`prover/device_challenger.py`), where the reference runs its
XLA permutation.  The kernels are `csrc/poseidon.cu`; the plain versions
beside them are the tensor Poseidon of `poseidon.py`.  A wrapper takes the
plain path only for a CPU tensor; for a CUDA tensor it launches its kernel
or raises.

K1 and K2 run in one of two regimes (`regime`): rows that fill the card go
to the throughput kernels (a thread a row, sparse partial rounds), fewer
rows to the latency kernels (16 lanes a row).
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Sequence, Union

import numpy as np
import torch

from .. import kernels
from . import goldilocks as gl
from . import poseidon, poseidon_sparse
from .poseidon_constants import MDS, N_ROUNDS, ROUND_CONSTANTS, SPONGE_RATE, WIDTH

# The most segments (device vectors and runs of words passed by value) and
# by-value words one K2t launch takes (csrc/poseidon.cu K2T_MAX_SEGS / _IMM).
MAX_SEGMENTS = 32
MAX_IMMEDIATE = 32

THREADS = 128  # a throughput kernel's block (csrc/poseidon.cu THREADS)
# A launch takes the latency kernels while its rows fill less than this
# share of the throughput kernel's resident threads (SMs x blocks an SM x
# THREADS): there a throughput launch costs one thread's permutation
# latency (~65 us on the H100), more than the latency kernels take; the two
# cross between 4,096 and 8,192 rows at 2 blocks an SM on 132 SMs
# (scripts/torch_poseidon_regimes.py, PERF.md).
FILL_SHARE = 0.25

_INITIALIZED = set()
_OCCUPANCY = {}  # device index -> kernel id -> blocks an SM
_THRESHOLD = {}  # device index -> kernel id -> regime_threshold


def full_round_constants() -> np.ndarray:
    """[8, 12]: the constant each full round's MDS sum folds in: the next
    round's, after round 3 the first partial round's whole vector
    (`poseidon_sparse.FIRST_CONSTANTS`), after the last round 0."""
    rc = ROUND_CONSTANTS.reshape(N_ROUNDS, WIDTH)
    half = poseidon_sparse.HALF_FULL
    rows = [rc[1], rc[2], rc[3], poseidon_sparse.FIRST_CONSTANTS]
    rows += [rc[N_ROUNDS - half + 1 + i] for i in range(half - 1)] + [np.zeros(WIDTH, np.uint64)]
    return np.stack(rows).astype(np.uint64)


def kernel_tables() -> list:
    """Every table `csrc/poseidon.cu` reads, in `p2_poseidon_init`'s order,
    flat as the kernels index them: the round constants [30 * 12], the MDS
    [12 * 12], the full rounds' folded constants [8 * 12], the sparse
    partial rounds' initial matrix [11 * 11], scalars [22], rows
    [22 * 12] (m00, then `SPARSE_ROWS[k]`) and columns [22 * 11]."""
    ps = poseidon_sparse
    row = np.concatenate([np.full((ps.PARTIAL_ROUNDS, 1), ps.M00, np.uint64), ps.SPARSE_ROWS], 1)
    flat = lambda t, dtype: np.ascontiguousarray(t, dtype=dtype).ravel()  # noqa: E731
    return [flat(ROUND_CONSTANTS, np.uint64), flat(MDS, np.uint32)] + [
        flat(t, np.uint64)
        for t in (full_round_constants(), ps.INIT_MATRIX, ps.ROUND_SCALARS, row, ps.SPARSE_COLS)]


def install_constants(lib) -> None:
    """Install `kernel_tables` on the current device (`p2_poseidon_init` of
    `lib`)."""
    tables = kernel_tables()
    kernels.check(lib.p2_poseidon_init(*[t.ctypes.data for t in tables]), "poseidon constants")


def _lib(device: torch.device):
    lib = kernels.library()
    idx = _index(device)
    if idx not in _INITIALIZED:
        with torch.cuda.device(idx):
            install_constants(lib)
            blocks = (ctypes.c_int * 2)()
            kernels.check(lib.p2_poseidon_occupancy(blocks), "poseidon occupancy")
        sms = torch.cuda.get_device_properties(idx).multi_processor_count
        _OCCUPANCY[idx] = {"K1": blocks[0], "K2": blocks[1]}
        _THRESHOLD[idx] = {k: regime_threshold(sms, b) for k, b in _OCCUPANCY[idx].items()}
        _INITIALIZED.add(idx)
    return lib


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def occupancy(device: torch.device) -> dict:
    """The blocks of THREADS an SM holds of the throughput kernels on
    `device`, by kernel id (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    _lib(device)
    return dict(_OCCUPANCY[_index(device)])


def regime_threshold(sms: int, blocks_per_sm: int) -> int:
    """The fewest rows that take the throughput kernels: FILL_SHARE of the
    threads the throughput kernel keeps resident on `sms` SMs at
    `blocks_per_sm` blocks an SM (its occupancy)."""
    return math.ceil(FILL_SHARE * sms * blocks_per_sm * THREADS)


def regime(rows: int, sms: int, blocks_per_sm: int) -> str:
    """"latency" below `regime_threshold`, else "throughput"."""
    return "latency" if rows < regime_threshold(sms, blocks_per_sm) else "throughput"


def device_threshold(kernel_id: str, device: torch.device) -> int:
    """`regime_threshold` of K1 or K2 on `device` (its SM count and the
    kernel's occupancy, cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    _lib(device)
    return _THRESHOLD[_index(device)][kernel_id]


def device_regime(kernel_id: str, rows: int, device: torch.device) -> str:
    """`regime` of a launch of K1 or K2 with `rows` rows on `device`."""
    return "latency" if rows < device_threshold(kernel_id, device) else "throughput"


def hash_leaves_plain(leaves: torch.Tensor) -> torch.Tensor:
    """[N, W] -> [N, 4]: the sponge of every row (plain version of K1)."""
    return poseidon.hash_no_pad(leaves)


def permute_states_plain(states: torch.Tensor) -> torch.Tensor:
    """[N, 12] -> [N, 12]: the permutation of every row (plain version of K2)."""
    return poseidon.permute(states)


_REGIME_ARG = {"throughput": 0, "latency": 1}


def launch_hash_leaves(leaves: torch.Tensor, regime_name: str) -> torch.Tensor:
    """K1 on a CUDA tensor in the given regime (`hash_leaves` picks it)."""
    kernels.require_cuda_int64(leaves, "hash_leaves", ndim=2)
    n, w = leaves.shape
    out = torch.empty((n, 4), dtype=torch.int64, device=leaves.device)
    if n:
        lib = _lib(leaves.device)
        kernels.check(
            lib.p2_hash_leaves(leaves.data_ptr(), out.data_ptr(), n, w, _REGIME_ARG[regime_name],
                               kernels.stream_of(leaves)),
            "hash_leaves",
        )
        kernels.count_launch("K1", (n, w))
    return out


def hash_leaves(leaves: torch.Tensor) -> torch.Tensor:
    """[N, W] int64 leaves -> [N, 4] Poseidon digests (K1)."""
    if kernels.is_plain(leaves):
        return hash_leaves_plain(leaves)
    return launch_hash_leaves(leaves, device_regime("K1", leaves.shape[0], leaves.device))


def launch_permute_states(states: torch.Tensor, regime_name: str) -> torch.Tensor:
    """K2 on a CUDA tensor in the given regime (`permute_states` picks it)."""
    kernels.require_cuda_int64(states, "permute_states", ndim=2)
    n, w = states.shape
    if w != WIDTH:
        raise ValueError(f"permute_states: expected width {WIDTH}, got {w}")
    out = torch.empty_like(states)
    if n:
        lib = _lib(states.device)
        kernels.check(
            lib.p2_permute_states(states.data_ptr(), out.data_ptr(), n, _REGIME_ARG[regime_name],
                                  kernels.stream_of(states)),
            "permute_states",
        )
        kernels.count_launch("K2", (n,))
    return out


def permute_states(states: torch.Tensor) -> torch.Tensor:
    """[N, 12] int64 states -> [N, 12] Poseidon-permuted states (K2)."""
    if kernels.is_plain(states):
        return permute_states_plain(states)
    return launch_permute_states(states, device_regime("K2", states.shape[0], states.device))


# ---------------------------------------------------------------------------
# K1m: the Merkle levels above a level of digests
# ---------------------------------------------------------------------------


def _check_tree(digests: torch.Tensor, n_levels: int) -> None:
    if digests.dim() != 2 or digests.shape[1] != 4:
        raise ValueError(f"hash_tree_levels: expected [n, 4] digests, got {tuple(digests.shape)}")
    if n_levels < 0 or digests.shape[0] % (1 << n_levels):
        raise ValueError(f"hash_tree_levels: {digests.shape[0]} digests do not halve "
                         f"{n_levels} times")


def hash_tree_levels_plain(digests: torch.Tensor, n_levels: int) -> List[torch.Tensor]:
    """Plain version of `hash_tree_levels`: each level the sponge of the
    level below as [m, 8] pair rows (two_to_one(l, r) == hash_no_pad(l || r))."""
    _check_tree(digests, n_levels)
    levels = []
    for _ in range(n_levels):
        digests = hash_leaves_plain(digests.reshape(-1, 8))
        levels.append(digests)
    return levels


def launch_tree_levels(digests: torch.Tensor, n_levels: int) -> List[torch.Tensor]:
    """The `n_levels` levels above `digests` in one K1m launch (any row
    count; `hash_tree_levels` gives K1m the levels below the threshold)."""
    n = digests.shape[0]
    rows = [n >> (i + 1) for i in range(n_levels)]
    out = torch.empty((sum(rows), 4), dtype=torch.int64, device=digests.device)
    lib = _lib(digests.device)
    counters = torch.zeros(lib.p2_tree_counters(n), dtype=torch.int32, device=digests.device)
    kernels.check(
        lib.p2_tree_levels(digests.data_ptr(), out.data_ptr(), n, n_levels, counters.data_ptr(),
                           kernels.stream_of(digests)),
        "tree_levels",
    )
    kernels.count_launch("K1m", (n, n_levels))
    return list(out.split(rows))


def hash_tree_levels(digests: torch.Tensor, n_levels: int) -> List[torch.Tensor]:
    """[n, 4] digests -> the `n_levels` Merkle levels above them, each its
    own [m, 4] tensor (level i has n / 2^(i+1) rows).  Levels whose rows
    reach the throughput regime are one K1 launch each; every level below
    it goes into one K1m launch."""
    if kernels.is_plain(digests):
        return hash_tree_levels_plain(digests, n_levels)
    kernels.require_cuda_int64(digests, "hash_tree_levels", ndim=2)
    _check_tree(digests, n_levels)
    levels = []
    while len(levels) < n_levels and device_regime("K1", digests.shape[0] // 2,
                                                   digests.device) == "throughput":
        digests = launch_hash_leaves(digests.reshape(-1, 8), "throughput")
        levels.append(digests)
    if len(levels) < n_levels:
        levels += launch_tree_levels(digests, n_levels - len(levels))
    return levels


# ---------------------------------------------------------------------------
# K2t: one transcript transition
# ---------------------------------------------------------------------------


def sponge_schedule(n_words: int, n_out: int, n_squeeze: int) -> tuple:
    """The duplex schedule of one transition of plonky2's sponge: absorb
    `n_words` words after the last permutation (words already buffered
    count among them) with `n_out` outputs pending, then squeeze
    `n_squeeze`.  Every 8th word permutes; any word drops the pending
    outputs; a squeeze duplexes when input is buffered or no output is left.
    Returns (the permutations, each as (first stream word, words written
    over state[:8]); leftover input words; outputs left; the squeezes, each
    as (permutations before it, state word))."""
    perms = [(SPONGE_RATE * c, SPONGE_RATE) for c in range(n_words // SPONGE_RATE)]
    fill = n_words % SPONGE_RATE
    if n_words:
        n_out = SPONGE_RATE if perms and not fill else 0
    outs = []
    for _ in range(n_squeeze):
        if fill or not n_out:
            perms.append((n_words - fill, fill))
            fill, n_out = 0, SPONGE_RATE
        n_out -= 1
        outs.append((len(perms), n_out))
    return perms, fill, n_out, outs


Word = Union[torch.Tensor, int]


def stream_words(pending, vectors: Sequence[Word], device) -> torch.Tensor:
    """The words of one transition as one 1-D tensor: `pending`, then each
    vector, python ints as words."""
    parts = [] if pending is None else [pending.reshape(-1)]
    for v in vectors:
        if isinstance(v, torch.Tensor):
            parts.append(v.reshape(-1))
        else:
            parts.append(torch.full((1,), gl.i64(int(v)), dtype=torch.int64, device=device))
    if not parts:
        return torch.zeros(0, dtype=torch.int64, device=device)
    return torch.cat(parts)


def sponge_transitions_plain(states: torch.Tensor, streams: List[torch.Tensor],
                             n_outs: Sequence[int], n_squeezes: Sequence[int]) -> list:
    """Plain version of K2t on a batch of transitions in lockstep: row b of
    `states` ([B, 12]) absorbs `streams[b]` with `n_outs[b]` outputs
    pending, then squeezes `n_squeezes[b]`; each step is one
    `poseidon.permute` of [B, 12], rows past their schedule kept.  Returns
    per row (state [12], leftover words [fill], outputs [k])."""
    dev = states.device
    B = states.shape[0]
    plans = [sponge_schedule(int(w.shape[0]), o, k) for w, o, k in zip(streams, n_outs, n_squeezes)]
    steps = max([len(plan[0]) for plan in plans] + [0])
    width = max([int(w.shape[0]) for w in streams] + [0]) + SPONGE_RATE
    words = torch.zeros((B, width), dtype=torch.int64, device=dev)
    for b, w in enumerate(streams):
        words[b, : w.shape[0]] = w
    idx = np.zeros((steps, B, SPONGE_RATE), dtype=np.int64)
    take = np.zeros((steps, B, SPONGE_RATE), dtype=bool)
    live = np.zeros((steps, B, 1), dtype=bool)
    for b, plan in enumerate(plans):
        for t, (start, count) in enumerate(plan[0]):
            idx[t, b] = start + np.arange(SPONGE_RATE)
            take[t, b, :count] = True
            live[t, b] = True
    idx, take, live = (torch.from_numpy(a).to(dev) for a in (idx, take, live))
    snaps = [states]
    for t in range(steps):
        head = torch.where(take[t], words.gather(1, idx[t]), states[:, :SPONGE_RATE])
        new = poseidon.permute(torch.cat([head, states[:, SPONGE_RATE:]], dim=1))
        states = torch.where(live[t], new, states)
        snaps.append(states)
    snaps = torch.stack(snaps)
    out = []
    for b, (w, (_, fill, _, outs)) in enumerate(zip(streams, plans)):
        n = int(w.shape[0])
        if outs:
            at = torch.tensor([t for t, _ in outs], device=dev)
            pos = torch.tensor([j for _, j in outs], device=dev)
            outputs = snaps[at, b, pos]
        else:
            outputs = states.new_zeros(0)
        out.append((states[b], words[b, n - fill : n], outputs))
    return out


def sponge_transition_plain(state: torch.Tensor, pending, vectors: Sequence[Word],
                            n_squeeze: int, n_out: int = 0) -> tuple:
    """Plain version of K2t: one transition, one `poseidon.permute` of
    [1, 12] per duplex.  See `sponge_transition`."""
    words = stream_words(pending, vectors, state.device)
    return sponge_transitions_plain(state[None], [words], [n_out], [n_squeeze])[0]


def sponge_transition(state: torch.Tensor, pending, vectors: Sequence[Word], n_squeeze: int,
                      n_out: int = 0) -> tuple:
    """One transcript transition (K2t).  `state`: the [12] sponge state;
    `pending`: the 1-D words absorbed since its last permutation (or None);
    `vectors`: 1-D tensors and python ints (words passed by value), absorbed
    in order after them; `n_out`: the outputs pending, state[:n_out]; then
    `n_squeeze` squeezes.  Returns (new state [12], leftover input words
    [fill], the outputs [n_squeeze]), views of one new tensor."""
    if kernels.is_plain(state):
        return sponge_transition_plain(state, pending, vectors, n_squeeze, n_out)
    kernels.require_cuda_int64(state, "sponge_transition", ndim=1)
    if state.shape[0] != WIDTH:
        raise ValueError(f"sponge_transition: expected a state of {WIDTH} words")
    if not 0 <= n_out <= SPONGE_RATE or n_squeeze < 0:
        raise ValueError(f"sponge_transition: n_out {n_out}, n_squeeze {n_squeeze}")
    ptrs, lens, imm = [], [], []
    n_pending = 0
    if pending is not None and pending.numel():
        kernels.require_cuda_int64(pending, "sponge_transition pending", ndim=1)
        n_pending = int(pending.shape[0])
        ptrs.append(pending.data_ptr())
        lens.append(n_pending)
    for v in vectors:
        if isinstance(v, torch.Tensor):
            kernels.require_cuda_int64(v, "sponge_transition vector", ndim=1)
            if v.device != state.device:
                raise ValueError(f"sponge_transition: a vector on {v.device}, the state on {state.device}")
            if v.numel():
                ptrs.append(v.data_ptr())
                lens.append(int(v.shape[0]))
        else:
            if not ptrs or ptrs[-1] is not None:
                ptrs.append(None)
                lens.append(0)
            lens[-1] += 1
            imm.append(gl.u64(int(v)))
    if len(ptrs) > MAX_SEGMENTS or len(imm) > MAX_IMMEDIATE:
        raise ValueError(f"sponge_transition: {len(ptrs)} segments and {len(imm)} words by value "
                         f"(at most {MAX_SEGMENTS} and {MAX_IMMEDIATE})")
    n_words = sum(lens)
    fill = sponge_schedule(n_words, n_out, n_squeeze)[1]
    out = torch.empty(WIDTH + SPONGE_RATE + n_squeeze, dtype=torch.int64, device=state.device)
    lib = _lib(state.device)
    kernels.check(
        lib.p2_sponge_transition(
            state.data_ptr(), out.data_ptr(), (ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_int64 * len(lens))(*lens), len(lens), (ctypes.c_uint64 * len(imm))(*imm),
            len(imm), n_out, n_squeeze, kernels.stream_of(state)),
        "sponge_transition",
    )
    kernels.count_launch("K2t", (n_pending, n_words - n_pending, n_out, n_squeeze))
    return out[:WIDTH], out[WIDTH : WIDTH + fill], out[WIDTH + SPONGE_RATE :]
