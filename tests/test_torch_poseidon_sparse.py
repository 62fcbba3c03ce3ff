"""The sparse partial rounds, the kernels' tables and the regime choice of
K1/K2 (csrc/poseidon.cu), on the CPU.

The sparse-form plain permutation (`poseidon_sparse.permute`) is held
against the port's dense `poseidon.permute` and the JAX package's
permutation.  The CUDA kernels cannot run here, so their flows are modelled
in python ints over the exact flat tables `p2_poseidon_init` installs
(`poseidon_cuda.kernel_tables`), step for step as the kernels index them:
the one-thread permutation of the throughput kernels (folded constants,
initial matrix, sparse rounds) and K1m's block and level schedule.  (The
latency kernels run K2t's warp core, which K2t's tests hold.)  The card
tests (tests/test_torch_cuda.py) hold the kernels themselves.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plonky2_bn254_tpu.field import poseidon as jpos
from plonky2_bn254_tpu_torch import bounds
from plonky2_bn254_tpu_torch.field import goldilocks as gl
from plonky2_bn254_tpu_torch.field import poseidon, poseidon_cuda, poseidon_sparse
from plonky2_bn254_tpu_torch.interop import tensor_from_u64, u64_from_tensor

torch.set_num_threads(2)

P = gl.P
EDGE = [0, 1, P - 1, P]


def states_with_edges(n: int, seed: int) -> np.ndarray:
    """n random u64 states; the first 4 all one edge word, the next 48 one
    edge word at one position."""
    s = np.random.default_rng(seed).integers(0, 2**64 - 1, (n, 12), dtype=np.uint64, endpoint=True)
    for i, e in enumerate(EDGE):
        s[i] = e
        for j in range(12):
            s[4 + 12 * i + j, j] = e
    return s


def test_sparse_permutation_equals_dense_and_jax():
    s = states_with_edges(256, 5)
    t = tensor_from_u64(s)
    got = u64_from_tensor(poseidon_sparse.permute(t))
    np.testing.assert_array_equal(got, u64_from_tensor(poseidon.permute(t)))
    np.testing.assert_array_equal(got, np.asarray(jpos.permute(jnp.asarray(s))))


def test_sparse_tables_shapes_and_last_scalar():
    ps = poseidon_sparse
    assert ps.FIRST_CONSTANTS.shape == (12,) and ps.INIT_MATRIX.shape == (11, 11)
    assert ps.SPARSE_ROWS.shape == ps.SPARSE_COLS.shape == (22, 11)
    assert ps.ROUND_SCALARS.shape == (22,) and ps.ROUND_SCALARS[-1] == 0
    assert ps.M00 == int(poseidon.MDS[0][0])
    # the last round's column is the MDS's own (nothing moved into it)
    np.testing.assert_array_equal(ps.SPARSE_COLS[-1], poseidon.MDS[1:, 0])
    for t in (ps.FIRST_CONSTANTS, ps.INIT_MATRIX, ps.ROUND_SCALARS, ps.SPARSE_ROWS, ps.SPARSE_COLS):
        assert (t < P).all()


def _tables():
    rc, mds, full_next, init, scalar, row, col = (
        [int(v) for v in t] for t in poseidon_cuda.kernel_tables())
    return dict(rc=rc, mds=mds, full_next=full_next, init=init, scalar=scalar, row=row, col=col)


def thread_permute(state, tb):
    """csrc/poseidon.cu `permute` (one thread) in python ints."""
    s = [(x + tb["rc"][e]) % P for e, x in enumerate(state)]

    def full_round(s, f):
        s = [pow(x, 7, P) for x in s]
        return [(sum(tb["mds"][12 * i + j] * s[j] for j in range(12)) + tb["full_next"][12 * f + i]) % P
                for i in range(12)]

    for f in range(4):
        s = full_round(s, f)
    s = [s[0]] + [sum(s[1 + j] * tb["init"][11 * i + j] for j in range(11)) % P for i in range(11)]
    for k in range(22):
        x0 = (pow(s[0], 7, P) + tb["scalar"][k]) % P
        new0 = (x0 * tb["row"][12 * k] + sum(s[j] * tb["row"][12 * k + j] for j in range(1, 12))) % P
        s = [new0] + [(x0 * tb["col"][11 * k + i - 1] + s[i]) % P for i in range(1, 12)]
    s = [(x + tb["rc"][26 * 12 + e]) % P for e, x in enumerate(s)]
    for f in range(4, 8):
        s = full_round(s, f)
    return s


def test_thread_flow_over_its_tables_equals_the_permutation():
    """The one-thread flow, over the flat tables the throughput kernels
    read, gives the permutation (non-canonical words included)."""
    tb = _tables()
    for s in states_with_edges(64, 6):
        assert thread_permute([int(v) for v in s], tb) == poseidon.h_permute_plain([int(v) for v in s])


def tree_schedule(digests: torch.Tensor, n_levels: int) -> torch.Tensor:
    """csrc/poseidon.cu `tree_levels_kernel`'s schedule, stage by stage and
    node by node (which sibling finishes last does not change what it
    computes), each pair row hashed by K1's plain version: the flat output
    of every level."""
    n = digests.shape[0]
    rows0, tree_rows, depth, fanin = n >> 1, 16, 5, 32
    out = torch.full((sum(n >> (i + 1) for i in range(n_levels)) * 4,), -1, dtype=torch.int64)
    hash_rows = lambda words: poseidon_cuda.hash_leaves_plain(words.reshape(-1, 8)).reshape(-1)  # noqa: E731
    src, nodes, l, off = digests.reshape(-1), -(-rows0 // tree_rows), 0, 0
    while True:
        l0, off0 = l, off
        for node in range(nodes):
            l, off, level = l0, off0, None
            for d in range(depth):
                if l == n_levels:
                    break
                rows, per = rows0 >> l, tree_rows >> d
                base = node * per
                here = min(per, rows - base)
                level = hash_rows(src[base * 8:(base + here) * 8] if d == 0 else level[:here * 8])
                out[(off + base) * 4:(off + base + here) * 4] = level
                off += rows
                l += 1
        if l == n_levels:
            return out
        src = out[(off - (rows0 >> (l - 1))) * 4:off * 4]
        nodes = -(-nodes // fanin)


@pytest.mark.parametrize("n, n_levels", [(2, 1), (4, 2), (32, 5), (64, 6), (1024, 10),
                                         (1 << 12, 12), (1 << 11, 9), (96, 5),
                                         (192, 6), (2048, 1)])
def test_tree_schedule_gives_every_level(n, n_levels):
    """K1m's stages cover every level exactly: one block, one stage, two
    and three stages (the last with one block, or several), a full group
    and a partial one, uneven row counts, one level."""
    d = tensor_from_u64(np.random.default_rng(n).integers(0, P, (n, 4), dtype=np.uint64))
    want = torch.cat(poseidon_cuda.hash_tree_levels_plain(d, n_levels)).reshape(-1)
    assert torch.equal(tree_schedule(d, n_levels), want)


def test_hash_tree_levels_rejects_what_it_does_not_take():
    d = torch.zeros((12, 4), dtype=torch.int64)
    with pytest.raises(ValueError):
        poseidon_cuda.hash_tree_levels(d, 3)  # 12 does not halve 3 times
    with pytest.raises(ValueError):
        poseidon_cuda.hash_tree_levels(torch.zeros((8, 8), dtype=torch.int64), 1)
    assert poseidon_cuda.hash_tree_levels(d, 0) == []
    with pytest.raises(ValueError):  # neither the CPU nor CUDA: no plain path, no kernel
        poseidon_cuda.hash_tree_levels(torch.empty((4, 4), dtype=torch.int64, device="meta"), 1)


# ---------------------------------------------------------------------------
# The regime choice and the bounds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows, sms, blocks, want", [
    (1 << 13, 132, 2, "latency"),
    (1 << 14, 132, 2, "throughput"),
    (8447, 132, 2, "latency"),  # a quarter of 132 x 2 x 128 = 8,448 threads
    (8448, 132, 2, "throughput"),
    (1 << 14, 132, 4, "latency"),  # more resident blocks: the card fills later
    (1 << 12, 32, 2, "throughput"),  # a smaller card
    (1 << 14, 264, 2, "latency"),  # a larger one
    (1, 132, 2, "latency"),
    (1 << 20, 132, 2, "throughput"),
])
def test_regime_from_shape_sms_and_occupancy(rows, sms, blocks, want):
    assert poseidon_cuda.regime(rows, sms, blocks) == want
    threshold = poseidon_cuda.regime_threshold(sms, blocks)
    assert (rows < threshold) == (want == "latency")


def _bound(work, sms=132, mhz=1980.0):
    ops, nbytes, chain = work
    return bounds.bound_ms(ops, nbytes, sms, mhz, chain)


def test_latency_floor_of_small_shapes():
    """[16, 8] is one permutation's critical path at the clock; [16, 17] is
    three (three absorbs); K2 at [64, 12] is one."""
    mhz = 1980.0
    one = 1e3 * bounds.permutation_latency() / (mhz * 1e6)
    assert _bound(bounds.hash_leaves_work(16, 8)) == (pytest.approx(one), "operations")
    assert _bound(bounds.hash_leaves_work(16, 17))[0] == pytest.approx(3 * one)
    assert _bound(bounds.permute_states_work(64))[0] == pytest.approx(one)
    assert bounds.hash_leaves_work(16, 0) == (0, 16 * 32, 0)


def test_throughput_bound_of_large_shapes_unchanged():
    """[2^17, 781] and K2 at [2^20, 12] stay bound by the issue rate, at the
    operations' count alone."""
    peak = 128 * 132 * 1980e6
    ops, _, _ = bounds.hash_leaves_work(1 << 17, 781)
    assert ops == (1 << 17) * 98 * bounds.permutation_ops()
    assert _bound(bounds.hash_leaves_work(1 << 17, 781)) == (pytest.approx(1e3 * ops / peak),
                                                            "operations")
    ops, _, _ = bounds.permute_states_work(1 << 20)
    assert _bound(bounds.permute_states_work(1 << 20))[0] == pytest.approx(1e3 * ops / peak)


def test_tree_levels_bound_sums_its_levels():
    n, n_levels = 1 << 17, 13
    want = sum(_bound(bounds.hash_leaves_work(n >> (i + 1), 8))[0] for i in range(n_levels))
    got, by = bounds.tree_levels_bound_ms(n, n_levels, 132, 1980.0)
    assert got == pytest.approx(want) and by == "operations"
    # the small levels each cost a whole permutation latency
    one = _bound(bounds.hash_leaves_work(1, 8))[0]
    assert bounds.tree_levels_bound_ms(32, 5, 132, 1980.0)[0] == pytest.approx(5 * one)
