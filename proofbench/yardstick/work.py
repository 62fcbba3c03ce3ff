"""The least time an H100 could take for the hand kernels' work in a proof.

A frozen copy of the program's roofline arithmetic as it stood when the
benchmark was written (its file may change; this one may not), and the
work of one batch STARK proof reckoned from the cell's own shapes and
configuration, whatever kernels implement it:

  - each committed batch (trace, aux, quotient): the iNTT of its columns
    (the quotient: of its values on the LDE domain), the coset LDE, the
    Poseidon leaf hashes and the Merkle levels down to the cap;
  - each FRI layer: the arity-sized iNTTs of the folds, the leaf hashes of
    its groups and their Merkle levels; the final polynomial's iNTT;
  - the proof-of-work grind: 2^pow_bits permutations, the expected count.

A piece's bound is max(bytes / HBM rate, int32 ops / int32 peak), and for
a chain of dependent permutations at least its critical path (a leaf's
permutations in sequence; a Merkle level waits for the one below).

Peaks: 3.35 TB/s of HBM (NVIDIA's H100 SXM data sheet).  The int32 peak is
derived, not published: 128 instructions per clock per SM (four schedulers
of 32 lanes) x 132 SMs x 1,980 MHz, the maximum SM clock, = 33.45 T op/s.
Operation costs are the SASS instruction counts and latencies of the
program's Goldilocks operations on sm_90a with nvcc 12, fixed here.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
SMS = 132
CLOCK_MHZ = 1980.0
INT32_OPS_PER_CLK_PER_SM = 128
INT32_OPS_PER_S = INT32_OPS_PER_CLK_PER_SM * SMS * CLOCK_MHZ * 1e6

OP_COST = {"mul": 29, "add": 11, "sub": 5, "reduce": 19, "small_mul": 8}
OP_LATENCY = {"add": 37, "mul": 101, "reduce": 57, "small_mul": 10, "sum_add": 2}
FULL_ROUNDS, PARTIAL_ROUNDS, WIDTH, RATE, DIGEST = 8, 22, 12, 8, 4


def permutation_ops() -> int:
    """Full rounds dense; partial rounds in the sparse form (Poseidon paper,
    app. B): once 12 adds and an 11 x 11 product, then per round one S-box,
    one add, 23 products and 22 adds."""
    c, t = OP_COST, WIDTH
    full = t * c["add"] + t * 4 * c["mul"] + t * t * c["small_mul"] + t * c["reduce"]
    first = t * c["add"] + (t - 1) ** 2 * c["mul"] + (t - 1) * (t - 2) * c["add"]
    partial = (4 + 2 * t - 1) * c["mul"] + (1 + 2 * (t - 1)) * c["add"]
    return FULL_ROUNDS * full + first + PARTIAL_ROUNDS * partial


def _sum_finish(ready: list, step: int) -> int:
    ready = sorted(ready)
    while len(ready) > 1:
        a, b = ready.pop(0), ready.pop(0)
        ready.append(max(a, b) + step)
        ready.sort()
    return ready[0]


def round_latency(full: bool) -> int:
    lat = OP_LATENCY
    sbox, product = 3 * lat["mul"], lat["small_mul"] - lat["sum_add"]
    ready = [0] + [(sbox if full or e == 0 else 0) + product for e in range(WIDTH)]
    return _sum_finish(ready, lat["sum_add"]) + lat["reduce"]


def permutation_latency() -> int:
    """Cycles of one permutation's critical path, every round in sequence."""
    return FULL_ROUNDS * round_latency(True) + PARTIAL_ROUNDS * round_latency(False)


def bound_s(ops: int, nbytes: int, chain_cycles: int = 0) -> float:
    t_ops = max(ops / INT32_OPS_PER_S, chain_cycles / (CLOCK_MHZ * 1e6))
    return max(t_ops, nbytes / HBM_BYTES_PER_S)


def hash_leaves_s(n: int, w: int) -> float:
    """n leaves of w words: ceil(w / 8) permutations a leaf, in sequence."""
    chunks = -(-w // RATE)
    return bound_s(n * chunks * permutation_ops(), 8 * n * w + 8 * DIGEST * n,
                   chunks * permutation_latency())


def permute_states_s(n: int) -> float:
    return bound_s(n * permutation_ops(), 2 * 8 * WIDTH * n, permutation_latency())


def tree_s(n: int, cap_height: int) -> float:
    """The Merkle levels above n digests down to a cap of 2^cap_height:
    level i hashes n / 2^(i+1) pairs, after level i - 1."""
    levels = n.bit_length() - 1 - cap_height
    return sum(hash_leaves_s(n >> (i + 1), 2 * DIGEST) for i in range(levels))


def _dft_ops(k: int, products: int) -> int:
    return (1 << k) // 2 * k * (OP_COST["add"] + OP_COST["sub"]) + products * OP_COST["mul"]


def intt_s(w: int, n: int) -> float:
    """w inverse transforms of n points: no product by a unit twiddle, n^-1
    folded into the four-step twiddles."""
    k = n.bit_length() - 1
    products = (n // 2) * k - (n - 1)
    if k > 0:
        products += (1 << (k - k // 2)) + (1 << (k // 2)) - 1
    return bound_s(w * _dft_ops(k, products), 16 * w * n)


def coset_lde_s(w: int, n: int, rate_bits: int) -> float:
    """w columns of n coefficients to n << rate_bits values on the coset."""
    k = n.bit_length() - 1
    blocks = 1 << rate_bits
    ops = blocks * _dft_ops(k, 0) + blocks * (n // 2) * k * OP_COST["mul"]
    return bound_s(w * ops, 8 * w * n + 8 * w * (n << rate_bits))


def fri_layers(n_log: int, cfg: dict):
    out, m_log, deg = [], n_log + cfg["rate_bits"], n_log
    while deg > cfg["final_poly_degree_bits"]:
        a = min(cfg["arity_bits"], deg - cfg["final_poly_degree_bits"])
        out.append((m_log, a))
        m_log, deg = m_log - a, deg - a
    return out, m_log


def batch_prove_least_s(width: int, aux_width: int, n_log: int, cfg: dict,
                        skip=()) -> float:
    """Least seconds of the hand kernels' work in one proof of a
    [2^n_log, width] trace with `aux_width` aux columns at config `cfg`;
    with "quotient" in `skip`, without the quotient's iNTT and commit (the
    work of the prover's "quotient" scope)."""
    n, rate, cap = 1 << n_log, cfg["rate_bits"], cfg["cap_height"]
    big = n << rate
    quotient = 2 * cfg["num_challenges"]
    total = 0.0
    for w in (width, aux_width):
        total += intt_s(w, n) + coset_lde_s(w, n, rate) + hash_leaves_s(big, w) + tree_s(big, cap)
    if "quotient" not in skip:
        total += (intt_s(cfg["num_challenges"], big) + coset_lde_s(quotient, n, rate)
                  + hash_leaves_s(big, quotient) + tree_s(big, cap))
    layers, final_m_log = fri_layers(n_log, cfg)
    for m_log, a in layers:
        groups = 1 << (m_log - a)
        total += intt_s(2 * groups, 1 << a) + hash_leaves_s(groups, 4 << a) + tree_s(groups, cap)
    total += intt_s(2, 1 << final_m_log)
    return total + permute_states_s(1 << cfg["proof_of_work_bits"])
