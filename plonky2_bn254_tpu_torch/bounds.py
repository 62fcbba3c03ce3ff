"""The least time an H100 could take for each kernel's work (`bound_ms`).

bound = max(bytes / HBM rate, int32 ops / int32 peak), counted from the
algorithm and the shapes, not from the kernels:
  - bytes: each input word read once, each output word written once;
  - ops: the field operations the function needs, in the cheapest form
    known for it, each at a fixed int32 instruction cost (`OP_COST`):
    no product by a unit twiddle, the iNTT's n^-1 folded into a twiddle
    table, Poseidon's partial rounds in their sparse form;
  - the int32 peak: 128 instructions per clock per SM, the issue rate of
    four schedulers of 32 lanes, times the SM count times the card's
    maximum SM clock.  The CUDA guide's 64 per clock per SM is the rate of
    one instruction class; integer work runs on two pipes (the IMAD family
    on the FMA pipe, the rest on the INT pipe), so only the issue rate
    bounds every mix.

`OP_COST` is fixed here once: the SASS instruction counts of
`csrc/goldilocks.cuh`, which `sass_costs` recounts from a build of
`csrc/op_probe.cu` (one operation per kernel, less the baseline's
instructions).  Building and disassembling need nvcc and cuobjdump;
importing this module needs neither.

K2t (one transcript transition, `poseidon_cuda.sponge_transition`) is a
chain of m dependent permutations, so the throughput bound says little: its
bound is also at least the critical path of that chain in its cheapest form
(`transition_latency`), each dependent operation at the latency in cycles
that `op_latencies` measures (clock64() chains of `csrc/op_probe.cu`),
pinned in `OP_LATENCY`, at the card's maximum SM clock.  K1 and K2 carry the
same floor, a row's permutations in sequence (`permutation_latency` each),
which is what bounds them at few rows; K1m (the Merkle levels) is bound by
the sum of its levels' bounds, since each level waits for the one below.
"""

from __future__ import annotations

import pathlib
import re
import subprocess
from collections import Counter

from . import kernels

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT32_OPS_PER_CLK_PER_SM = 128

# SASS instructions per operation on 64-bit Goldilocks words (sm_90a, nvcc 12)
OP_COST = {
    "mul": 29,  # 64x64 -> 128 product and reduction (gl::mul)
    "add": 11,  # gl::add
    "sub": 5,  # gl::sub
    "reduce": 19,  # gl::reduce128 of a 128-bit sum
    "small_mul": 8,  # word times a 32-bit constant into two 64-bit sums (MDS)
}

# Cycles from a dependent operation's input to its output (sm_90a, nvcc 12):
# the clock64() chains of csrc/op_probe.cu, read by `op_latencies`.
OP_LATENCY = {
    "add": 37,  # gl::add
    "mul": 101,  # gl::mul
    "reduce": 57,  # gl::reduce128
    "small_mul": 10,  # one multiply-accumulate step of the MDS sum
    "sum_add": 2,  # one add of two 64-bit partial sums of the MDS sum
}

# Poseidon (width 12, rate 8): 8 full and 22 partial rounds, S-box x^7 in 4
# products.
POSEIDON_FULL_ROUNDS = 8
POSEIDON_PARTIAL_ROUNDS = 22
POSEIDON_WIDTH = 12
POSEIDON_RATE = 8


def permutation_ops() -> int:
    """Ops of one permutation.  A full round: 12 constant adds, 12 S-boxes
    and the dense MDS layer (144 small-constant products, 12 reductions).
    The partial rounds in the sparse form of the Poseidon paper (App. B) that
    plonky2's fast partial rounds use: once, 12 constant adds and an 11 x 11
    product by full-width constants (121 products, 110 adds); then a round is
    one S-box, one constant add, and 23 products and 22 adds (the first row
    and column of a sparse matrix), against 144 small products, 12
    reductions and 12 adds in the dense form."""
    c, t = OP_COST, POSEIDON_WIDTH
    full = t * c["add"] + t * 4 * c["mul"] + t * t * c["small_mul"] + t * c["reduce"]
    first = t * c["add"] + (t - 1) ** 2 * c["mul"] + (t - 1) * (t - 2) * c["add"]
    partial = (4 + 2 * t - 1) * c["mul"] + (1 + 2 * (t - 1)) * c["add"]
    return POSEIDON_FULL_ROUNDS * full + first + POSEIDON_PARTIAL_ROUNDS * partial


def _sum_finish(ready: list, step: int) -> int:
    """When a sum of terms ready at the times `ready` can be done at the
    earliest: add the two terms ready first, again and again, each add
    `step` cycles (the fastest order for adds of one cost)."""
    ready = sorted(ready)
    while len(ready) > 1:
        a, b = ready.pop(0), ready.pop(0)
        ready.append(max(a, b) + step)
        ready.sort()
    return ready[0]


def round_latency(full: bool, early: int = 0) -> int:
    """Cycles of one round's critical path in the cheapest form known, its
    words ready at its start with its round constant already added (the
    first `early` of them long before: words an absorb wrote): in a full
    round each word's S-box (in a partial one only word 0's), three
    dependent products (x^2; x^3 and x^4 side by side; x^7); then one MDS
    row: a small product per word, their sum with the next round's constant
    (known before the round, so a term ready at once) in the fastest order,
    and one reduction.  A product whose add into the sum is fused with it
    (a multiply-accumulate) takes `small_mul` for both, so each product is
    priced at `small_mul - sum_add` and each add of the sum at `sum_add`,
    which no order of fused and separate steps beats.  In a partial round
    the other 11 products are summed while word 0's S-box runs.  (The
    sparse form of the partial rounds trades the small products for full
    ones, a longer path, so the dense form is the cheaper here.)"""
    lat = OP_LATENCY
    sbox = 3 * lat["mul"]
    product = lat["small_mul"] - lat["sum_add"]
    ready = [0] + [0 if e < early else (sbox if full or e == 0 else 0) + product
                   for e in range(POSEIDON_WIDTH)]
    return _sum_finish(ready, lat["sum_add"]) + lat["reduce"]


def permutation_latency(early: int = 0) -> int:
    """Cycles of one permutation's critical path inside a chain, the first
    `early` words written by the absorb before it: every round in sequence,
    round 0's constant folded into the previous permutation's last MDS sum
    (or, for a word the absorb writes, added to the input word off the
    path)."""
    return (round_latency(True, early) + (POSEIDON_FULL_ROUNDS - 1) * round_latency(True)
            + POSEIDON_PARTIAL_ROUNDS * round_latency(False))


def transition_latency(written: list) -> int:
    """Cycles of the critical path of a chain of permutations, `written[i]`
    the words the absorb writes over state[:8] before permutation i
    (`sponge_schedule`): the first one's round-0 constant add, which
    nothing before it can take, and its path with every word read at the
    start, then each later permutation's path."""
    if not written:
        return 0
    return (OP_LATENCY["add"] + permutation_latency()
            + sum(permutation_latency(w) for w in written[1:]))


def sponge_transition_work(key: tuple) -> tuple:
    """(ops, bytes, permutations, critical path in cycles) of K2t at its
    launch key (pending words, absorbed words, pending outputs, squeezes):
    the permutations of the duplex schedule, the input words and state
    read, the new state, leftover words and outputs written."""
    from .field.poseidon_cuda import sponge_schedule

    n_pending, n_words, n_out, n_squeeze = key
    perms, fill, _, _ = sponge_schedule(n_pending + n_words, n_out, n_squeeze)
    nbytes = 8 * (POSEIDON_WIDTH + n_pending + n_words) + 8 * (POSEIDON_WIDTH + fill + n_squeeze)
    chain = transition_latency([count for _, count in perms])
    return len(perms) * permutation_ops(), nbytes, len(perms), chain


def hash_leaves_work(n: int, w: int) -> tuple:
    """(ops, bytes, critical path in cycles) of K1 on [n, w] leaves:
    ceil(w / 8) permutations a row, one after another."""
    chunks = -(-w // POSEIDON_RATE) if n else 0
    return (n * chunks * permutation_ops(), 8 * n * w + 32 * n,
            chunks * permutation_latency())


def permute_states_work(n: int) -> tuple:
    """(ops, bytes, critical path in cycles) of K2 on [n, 12] states."""
    return (n * permutation_ops(), 2 * 8 * POSEIDON_WIDTH * n,
            permutation_latency() if n else 0)


def tree_levels_bound_ms(n: int, n_levels: int, sms: int, clock_mhz: float) -> tuple:
    """(bound in ms, "operations" or "bytes") of K1m on the `n_levels`
    Merkle levels above n digests (level i: K1 on [n / 2^(i+1), 8] pair
    rows): the sum of each level's bound (the larger of its throughput and
    its latency), since a level starts only when the one below is done;
    labelled by the side that the larger part of that sum comes from."""
    parts = []
    for i in range(n_levels):
        ops, nbytes, chain = hash_leaves_work(n >> (i + 1), 2 * 4)
        parts.append(bound_ms(ops, nbytes, sms, clock_mhz, chain))
    total = sum(ms for ms, _ in parts)
    by_ops = sum(ms for ms, by in parts if by == "operations")
    return total, "operations" if 2 * by_ops >= total else "bytes"


def _dft_ops(n_log: int, products: int) -> int:
    """Ops of one 2^n_log-point transform: (n/2) log2 n butterflies, each an
    add and a sub, and `products` twiddle products."""
    butterflies = (1 << n_log) // 2 * n_log
    return butterflies * (OP_COST["add"] + OP_COST["sub"]) + products * OP_COST["mul"]


def ntt_work(w: int, n: int, inverse: bool) -> tuple:
    """(ops, bytes) of K3 on [w, n].  A row: (n/2) log2 n butterflies, of
    which n - 1 have the unit twiddle and no product.  The inverse folds n^-1
    into the four-step twiddles w_n^(k1 i2) of an n1 x n2 split (n1, n2 the
    powers of two nearest sqrt n), which costs the n1 + n2 - 1 of them that
    are 1 a product each."""
    k = n.bit_length() - 1
    products = (n // 2) * k - (n - 1)
    if inverse and k > 0:
        products += (1 << (k - k // 2)) + (1 << (k // 2)) - 1
    return w * _dft_ops(k, products), 16 * w * n


def coset_lde_work(w: int, n: int, rate_bits: int) -> tuple:
    """(ops, bytes) of K4 on [w, n] coefficients -> [w, n << rate_bits]
    values.  A row: n - 1 products by shift^i (shift^0 = 1); rate_bits DIF
    stages on zero-extended blocks, (a, 0) -> (a, a w^i), a product for each
    of the n - 1 non-unit twiddles of each block; then 2^rate_bits full
    n-point transforms.  The products sum to 2^rate_bits (n/2) log2 n."""
    k = n.bit_length() - 1
    blocks = 1 << rate_bits
    products = blocks * (n // 2) * k
    ops = blocks * _dft_ops(k, 0) + products * OP_COST["mul"]
    return w * ops, 8 * w * n + 8 * w * (n << rate_bits)


def quotient_work(tape, n: int) -> tuple:
    """(ops, bytes) of K5 running `tape` (prover/tape.py) at n coset points.
    Ops: the tape's Goldilocks operations at every point, each at its
    `OP_COST` (the uniform program runs once, not counted).  Bytes: each
    LDE word read once (the next row's words are the same words, `shift`
    points on), the four selector rows, and the outputs written."""
    from .prover import tape as tape_mod

    op = tape.prog[:, 0]
    cost = {tape_mod.ADD: OP_COST["add"], tape_mod.SUB: OP_COST["sub"],
            tape_mod.MUL: OP_COST["mul"]}
    per_point = sum(int((op == k).sum()) * c for k, c in cost.items())
    words = tape.width + tape.aux_width + 4 + tape.n_out
    return n * per_point, 8 * n * words


FERMAT_PRODUCTS = 73  # x^(p - 2): 64 squarings and 9 products (csrc/inverse.cu)


def batch_inv_work(n: int) -> tuple:
    """(ops, bytes, critical path in cycles) of K6 inverting n elements:
    Montgomery's trick, 3 (n - 1) products (a prefix product up, two down)
    and one Fermat inversion of the whole batch's product, whose chain of
    dependent products bounds small batches; each element read once and
    written once."""
    if n == 0:
        return 0, 0, 0
    products = 3 * (n - 1) + FERMAT_PRODUCTS
    return (products * OP_COST["mul"], 16 * n, FERMAT_PRODUCTS * OP_LATENCY["mul"])


def combine_work(k: int, n: int, points: int, over_rows: bool = False) -> tuple:
    """(ops, bytes) of K7 on a [k, n] batch of base values, each weighted
    by extension values and summed, in the cheapest form known: a product
    kept as 128 bits (`mul` less its `reduce`: the sums defer their
    reduction, so pricing each product as a full `mul` would let a kernel
    beat its bound), one `reduce` a coordinate of each sum, the adds into
    the sums not counted; each input word read once, each output written
    once.
      K7r (the openings, over_rows False): each row's sum over its n
    coefficients at `points` points, 2 points products a coefficient; the
    powers z^t made on chip, one extension product (3 products) a power
    and point.
      K7c (the FRI oracle, over_rows True): each of the n coset points' sum
    over the k rows, alpha^j read (16 bytes a row), 2 products a value;
    then `points` quotients a coset point, each a norm (2 products), its
    inverse (3, Montgomery's trick), the inverse's coordinates (2) and the
    numerator times it (3), and alpha^n times the last (3)."""
    wide = OP_COST["mul"] - OP_COST["reduce"]
    if not over_rows:
        ops = (2 * points * k * n * wide + 2 * points * k * OP_COST["reduce"]
               + 3 * points * n * OP_COST["mul"])
        return ops, 8 * k * n + 16 * points * k
    ops = 2 * k * n * wide + 2 * n * OP_COST["reduce"] + (10 * points + 3) * n * OP_COST["mul"]
    return ops, 8 * k * n + 16 * k + 16 * n


def bound_ms(ops: int, nbytes: int, sms: int, clock_mhz: float, chain_cycles: int = 0) -> tuple:
    """(bound in ms, "operations" or "bytes").  `chain_cycles`: the critical
    path of operations that depend on one another (K1, K2, K2t, K6), which
    bounds them from below at the clock as the issue rate does."""
    t_ops = max(ops / (INT32_OPS_PER_CLK_PER_SM * sms * clock_mhz * 1e6),
                chain_cycles / (clock_mhz * 1e6))
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


def sass_costs(out_dir: pathlib.Path) -> tuple:
    """(cost of each operation, opcodes of gl::mul): each probe kernel's
    instructions beyond the baseline's, plus the baseline's two LOP3s."""
    out_dir = out_dir.resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = kernels._nvcc()
    cubin = out_dir / "op_probe.cubin"
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    subprocess.run([nvcc, *flags, "-cubin", "-o", str(cubin), str(kernels.CSRC / "op_probe.cu")],
                   check=True, capture_output=True, text=True, cwd=str(kernels.CSRC))
    cuobjdump = pathlib.Path(nvcc).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    opcodes, current = {}, None
    for line in sass.splitlines():
        head = re.search(r"Function : (\w+)", line)
        if head:
            current = opcodes.setdefault(head.group(1), Counter())
            continue
        ins = re.search(r"/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if current is not None and ins and ins.group(2) not in ("NOP", "BRA", "EXIT"):
            current[ins.group(2)] += 1
    base = sum(opcodes["probe_xor"].values())
    costs = {name[len("probe_"):]: sum(c.values()) - base + 2
             for name, c in opcodes.items() if name.startswith("probe_") and name != "probe_xor"}
    return costs, dict(opcodes["probe_mul"])


LATENCY_OPS = ("add", "mul", "reduce", "small_mul", "sum_add")  # the order of p2_op_latencies


def probe_library(out_dir: pathlib.Path):
    """`csrc/op_probe.cu` built as a library into `out_dir` (ctypes)."""
    import ctypes

    out_dir = out_dir.resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "libopprobe.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(so),
                    str(kernels.CSRC / "op_probe.cu")],
                   check=True, capture_output=True, text=True, cwd=str(kernels.CSRC))
    return ctypes.CDLL(str(so))


def op_latencies(out_dir: pathlib.Path) -> tuple:
    """(cycles per dependent step of each operation, rounded; unrounded)
    from the clock64() chains of `csrc/op_probe.cu`, built as a library
    and run on the current CUDA device: the difference of a 4096-step and
    a 1024-step chain over 3072."""
    import ctypes

    import torch

    lib = probe_library(out_dir)
    lib.p2_op_latencies.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.p2_op_latencies.restype = ctypes.c_int
    n = len(LATENCY_OPS)
    scratch = torch.zeros(2 + 2 * n, dtype=torch.int64, device="cuda")
    scratch[0], scratch[1] = 0x0123456789ABCDEF, 0x00000000FEDCBA98
    cycles = (ctypes.c_longlong * (2 * n))()
    kernels.check(lib.p2_op_latencies(scratch.data_ptr(), cycles), "op latencies")
    raw = {op: (cycles[2 * i + 1] - cycles[2 * i]) / 3072 for i, op in enumerate(LATENCY_OPS)}
    return {op: round(v) for op, v in raw.items()}, raw
