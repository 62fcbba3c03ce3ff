"""The operation counts of `plonky2_bn254_tpu_torch.bounds` against a
butterfly-by-butterfly count of the radix-2 DIF transform, and the launch
keys the wrappers record for the chip smoke's shape list."""

import numpy as np
import pytest

from plonky2_bn254_tpu_torch import bounds, kernels
from plonky2_bn254_tpu_torch.field import ntt_cuda


def dif_counts(n_log: int, live: list) -> tuple:
    """(products, adds, subs) of a radix-2 DIF on 2^n_log words of which
    `live[i]` may be non-zero: a butterfly (a, b) -> (a + b, (a - b) w^e)
    needs the add only if both are live, the sub only if b is, and the
    product only if a or b is and w^e != 1."""
    n = 1 << n_log
    live = list(live)
    prods = adds = subs = 0
    h = n // 2
    while h >= 1:
        for blk in range(0, n, 2 * h):
            for j in range(h):
                a, b = live[blk + j], live[blk + j + h]
                adds += a and b
                subs += b
                prods += (a or b) and j * (n // (2 * h)) % n != 0
                live[blk + j] = live[blk + j + h] = a or b
        h //= 2
    return prods, adds, subs


def ops_of(prods: int, adds: int, subs: int) -> int:
    c = bounds.OP_COST
    return prods * c["mul"] + adds * c["add"] + subs * c["sub"]


@pytest.mark.parametrize("n_log", range(0, 11))
def test_ntt_ops_skip_unit_twiddles(n_log):
    n = 1 << n_log
    ops, nbytes = bounds.ntt_work(3, n, False)
    assert ops == 3 * ops_of(*dif_counts(n_log, [True] * n))
    assert nbytes == 3 * 16 * n


@pytest.mark.parametrize("n_log", range(0, 11))
def test_intt_ops_fold_n_inverse_into_the_four_step_table(n_log):
    """The inverse costs one product more for each unit entry of the
    four-step table w_n^(k1 i2) of the split n1 = 2^ceil, n2 = 2^floor."""
    n = 1 << n_log
    m1 = n_log - n_log // 2
    table = ntt_cuda._four_step(n_log, m1, True, False, "cpu") if n_log else np.ones(1)
    units = int((np.asarray(table) == 1).sum()) if n_log else 0
    fwd, _ = bounds.ntt_work(1, n, False)
    inv, _ = bounds.ntt_work(1, n, True)
    assert inv - fwd == units * bounds.OP_COST["mul"]


@pytest.mark.parametrize("n_log,rate_bits", [(k, r) for k in range(0, 9) for r in range(0, 4)])
def test_coset_lde_ops_skip_the_zero_extension(n_log, rate_bits):
    """Premultiply by shift^i (no product for i = 0), then the DIF on the
    zero-extended row, with no work on words known to be zero."""
    n = 1 << n_log
    big = n_log + rate_bits
    live = [i < n for i in range(1 << big)]
    prods, adds, subs = dif_counts(big, live)
    ops, nbytes = bounds.coset_lde_work(2, n, rate_bits)
    assert ops == 2 * ops_of(prods + n - 1, adds, subs)
    assert nbytes == 2 * 8 * (n + (n << rate_bits))


def test_permutation_ops_sparse_partial_rounds():
    """The sparse partial rounds cost less than the dense MDS form that the
    kernels run, and the full rounds are counted as written."""
    c, t = bounds.OP_COST, bounds.POSEIDON_WIDTH
    full = t * c["add"] + 4 * t * c["mul"] + t * t * c["small_mul"] + t * c["reduce"]
    dense_partial = t * c["add"] + 4 * c["mul"] + t * t * c["small_mul"] + t * c["reduce"]
    dense = 8 * full + 22 * dense_partial
    assert bounds.permutation_ops() < dense
    assert bounds.permutation_ops() > 8 * full + 22 * 4 * c["mul"]
    ops, nbytes, _ = bounds.hash_leaves_work(5, 17)
    assert ops == 5 * 3 * bounds.permutation_ops() and nbytes == 5 * (17 + 4) * 8


def test_bound_takes_the_larger_time():
    sms, mhz = 132, 1980.0
    t_ops, by = bounds.bound_ms(int(1e12), 0, sms, mhz)
    assert by == "operations"
    assert t_ops == pytest.approx(1e3 * 1e12 / (128 * sms * mhz * 1e6))
    t_bytes, by = bounds.bound_ms(0, int(3.35e9), sms, mhz)
    assert by == "bytes" and t_bytes == pytest.approx(1.0)


def test_count_launch_records_keys():
    kernels.reset_launches()
    kernels.count_launch("K3", (2, 8, 8, True))
    kernels.count_launch("K3", (2, 8, 8, True))
    kernels.count_launch("K4", (2, 8, 16, False))
    assert kernels.LAUNCHES["K3"] == 2 and kernels.CALLS["K3"] == {(2, 8, 8, True): 2}
    kernels.reset_launches()
    assert all(not kernels.CALLS[k] for k in kernels.KERNEL_IDS)


# ---------------------------------------------------------------------------
# K2t: the latency of one permutation and the work of a transition
# ---------------------------------------------------------------------------


def sum_finish(ready: list, step: int) -> int:
    """The earliest a sum of terms ready at `ready` is done by adds of
    `step` cycles: the least T at which a binary tree exists with term i at
    depth at most floor((T - ready_i) / step), which is when
    sum 2^-depth_i <= 1 (Kraft's inequality)."""
    for t in sorted({r + k * step for r in ready for k in range(len(ready))}):
        if t < max(ready):
            continue
        depths = [(t - r) // step for r in ready]
        if sum(1 << (max(depths) - d) for d in depths) <= 1 << max(depths):
            return t
    raise AssertionError("no tree")


class Dag:
    """A dependency graph: nodes in the order they are made, so a node's
    inputs come before it.  An op finishes its latency after the latest of
    its inputs; a sum finishes when its terms can be added at the
    earliest."""

    def __init__(self):
        self.nodes = []

    def op(self, latency: int, *inputs) -> int:
        self.nodes.append(("op", latency, inputs))
        return len(self.nodes) - 1

    def sum(self, step: int, terms) -> int:
        self.nodes.append(("sum", step, tuple(terms)))
        return len(self.nodes) - 1

    def longest_path(self) -> int:
        done = []
        for kind, cost, inputs in self.nodes:
            ready = [done[i] for i in inputs]
            done.append(max(ready, default=0) + cost if kind == "op" else sum_finish(ready, cost))
        return max(done)


def chain_dag(lat: dict, written: list) -> Dag:
    """The permutations of one transition op by op, as the permutation is
    written (constant add, S-box x^7 = x^4 x^3 with x^3 = x^2 x and
    x^4 = x^2 x^2 on every word of a full round and on word 0 of a partial
    one, then each MDS row: a small product per word, their sum, one
    reduction), `written[i]` words of state[:8] overwritten by input words
    before permutation i.  Inputs and constants are ready at once, so a
    round's constant is one more term of the MDS sum before it (the first
    permutation's round 0 excepted), and a product fused with its add costs
    `small_mul`: a product `small_mul - sum_add`, an add of the sum
    `sum_add`."""
    dag = Dag()
    given = dag.op(0)
    state = [dag.op(lat["add"], given) for _ in range(12)]
    n_rounds = bounds.POSEIDON_FULL_ROUNDS + bounds.POSEIDON_PARTIAL_ROUNDS
    half = bounds.POSEIDON_FULL_ROUNDS // 2
    for p, n_written in enumerate(written):
        if p:
            state[:n_written] = [dag.op(lat["add"], given) for _ in range(n_written)]
        for r in range(n_rounds):
            full = r < half or r >= n_rounds - half
            words = []
            for e, x in enumerate(state):
                if full or e == 0:
                    x2 = dag.op(lat["mul"], x)
                    x3, x4 = dag.op(lat["mul"], x2, x), dag.op(lat["mul"], x2)
                    x = dag.op(lat["mul"], x4, x3)
                words.append(x)
            constant = [] if p == len(written) - 1 and r == n_rounds - 1 else [given]
            state = [dag.op(lat["reduce"], dag.sum(lat["sum_add"], [
                dag.op(lat["small_mul"] - lat["sum_add"], w) for w in words] + constant))
                for _ in range(12)]
    return dag


@pytest.mark.parametrize("lat", [
    dict(bounds.OP_LATENCY),
    {"add": 9, "mul": 40, "reduce": 20, "small_mul": 14, "sum_add": 4},
    {"add": 3, "mul": 5, "reduce": 7, "small_mul": 6, "sum_add": 5},
])
@pytest.mark.parametrize("written", [[8], [8, 8, 8], [0, 0], [8, 3, 0], [5, 8]])
def test_transition_latency_is_its_critical_path(lat, written, monkeypatch):
    monkeypatch.setattr(bounds, "OP_LATENCY", lat)
    assert bounds.transition_latency(written) == chain_dag(lat, written).longest_path()


def test_sum_finish_takes_the_best_tree():
    """Twelve terms at once need four levels; a late term joins a tree of
    the early ones at the top."""
    assert sum_finish([0] * 12, 3) == 12
    assert sum_finish([0] * 11 + [100], 3) == 103
    assert sum_finish([0] * 8 + [50] * 4, 2) == 56


@pytest.mark.parametrize("key", [(0, 0, 0, 1), (0, 0, 5, 3), (7, 1, 0, 9), (0, 4964, 6, 2),
                                 (0, 65, 0, 4), (3, 0, 0, 0)])
def test_sponge_transition_work_counts_the_duplex_schedule(key):
    """Permutations: one per 8 words absorbed, one per squeeze that finds
    input buffered or no output left, as the host challenger runs them; the
    critical path of that chain with the words each one overwrites."""
    from plonky2_bn254_tpu_torch.prover.challenger import Challenger

    n_pending, n_words, n_out, n_squeeze = key
    host, perms = Challenger(), []
    host.state = [1] * 12
    host.input_buffer = [0] * n_pending
    host.output_buffer = [0] * n_out
    duplex = host._duplex
    host._duplex = lambda: (perms.append(min(len(host.input_buffer), 8)), duplex())
    host.observe_elements([0] * n_words)
    host.get_n_challenges(n_squeeze)
    ops, nbytes, n_perms, chain = bounds.sponge_transition_work(key)
    assert n_perms == len(perms)
    assert chain == bounds.transition_latency(perms)
    assert ops == n_perms * bounds.permutation_ops()
    assert nbytes == 8 * (12 + n_pending + n_words) + 8 * (12 + len(host.input_buffer) + n_squeeze)
