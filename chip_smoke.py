"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. the card: name, power limit and maximum SM clock from nvidia-smi;
  2. build the CUDA kernels from plonky2_bn254_tpu_torch/csrc (nvcc, sm_90a,
     one nvcc a source, all started together), and count the SASS
     instructions of each Goldilocks operation (bounds.sass_costs) and
     measure its latency in cycles (bounds.op_latencies, clock64() chains):
     they must equal the fixed costs and latencies the bounds use;
  3. the native host Poseidon (csrc/host_poseidon.cpp, g++ at first use):
     permute, hash_no_pad and two_to_one equal their python versions on
     random states and the edge words 0, 1, p - 1, p; verify_path accepts a
     real path and rejects a flipped sibling;
  4. the demo STARK proved on the card must equal its proof on the CPU
     (plain versions) bit for bit;
  5. the three machine paths, 128 ops from numpy.random.default_rng(2024):
       g1      128 G1 scalar multiplications s x + offset (as bench.py)
               -> generate_trace (2^16 x 781),
       fq_exp  128 exponentiations x^s -> generate_trace (2^16 x 427),
       g2      128 G2 scalar multiplications -> generate_trace (2^16 x 1295),
     each trace proved at DEFAULT_CONFIG three times, with the Fiat–Shamir
     transcript on the device (the default on the card), on the host, and
     on the device again (the first proof of a path meets cold tables),
     each with the launch counts set to 0 just before and read just after
     (every kernel launched; device FS through K2t, at most 16 transitions,
     and K2 never at [1, 12]; host FS no K2t), its synchronised
     wall and its synchronising CUDA operations (torch.cuda sync debug
     mode) by site; the proofs equal field by field; the device-FS
     proof verifies and is rejected with one opening flipped; one more
     host-FS proof under the synchronising timer gives its stage times; the
     wrappers record the shape of every launch (kernels.CALLS);
  5m. the mesh path, right after fq_exp's first proof: the same 2^16 x 427
     trace (written once to a file the ranks map, so no rank builds it)
     proved at DEFAULT_CONFIG by prove(..., mesh=...) on 4 ranks of a gloo
     group spawned on the one card (parallel/launch.py, file init in a
     temporary directory; the kernel library already built), the cases of
     MESH_CASES in turn: on the 1-D mesh twice with the host transcript and
     once with the device transcript, on the (2, 2) mesh of make_mesh2d
     with the rows over ("tp", "dp"), and with the rows over dp and the
     columns over tp (427 does not split over 2: replicated), then
     keyed_demo at TEST_CONFIG with its 6 columns split over tp; each
     rank's launch counts set to 0 just before each proof and read just
     after: every rank's proof equals the single-device proof field by
     field (fq_exp: the path's host-FS proof), K1, K2 and K3 launched on
     every rank, K4 never (the mesh LDE is two mesh NTTs), K2 never at
     [1, 12], K2t (at most 16 times) only in the device-FS proof; each proof
     verifies and is rejected with one opening flipped; printed per case:
     the barrier-to-barrier wall and rank 0's stages, each rank's peak
     device memory beside the single-device host-FS proof's, the bytes each
     rank sent (by axis on the 2-D mesh; the 1-D host proof's beside the
     model of the mesh transforms) and, for device FS, the synchronising
     operations by site (torch.cuda sync debug mode, which the device-FS
     wall includes); every rank's kernels.CALLS join the kernel phase as
     "mesh";
  6. the compose path, the circuit API's production product (as
     scripts/prove_compose_default.py and scripts/bench_outer.py define it):
     two fq_exp ops from numpy.random.default_rng(123) recorded on a
     CircuitBuilder, the first op's output limbs public, the hook and the
     outer proof at DEFAULT_CONFIG, table_bits 16:
       build          the in-circuit recursive FqExp verifier,
       witness        the inner FqExp batch proved on the card, self-verified
                      and injected (outputs checked against pow(x, s, P)),
       compile_outer  the 2^20-row universal-gate layout and its verifier key,
       outer proof    with the device transcript, the launch counts set to 0
                      just before it and read just after: every kernel
                      must have launched, K2 never at [1, 12],
     then verify_all, a corrupted public value and a flipped opening both
     rejected; then the outer proof with the host transcript and with the
     device one again (synchronised walls; equal to the first field by
     field; K2t launched only with the device transcript);
  7. the h2g phase: hash_to_g2_circuit over 4 inputs from
     numpy.random.default_rng(170), the real backend on the card (the hook
     at the inner config of tests/test_torch_cuda.py's three-kinds test
     proves the is_square fq_exp ops and the cofactor g2_scalar_mul), the
     output point public, one outer proof at TEST_CONFIG: the point equals
     the native hash_to_g2 mirror, verify_all accepts, a flipped opening is
     rejected, and every kernel launched during the phase;
  8. each kernel against its plain PyTorch version on the card, at every
     shape any path launched it with and at a few odd sizes, with
     torch.equal (exact integer arithmetic: the tolerance is zero); the
     kernel timed at each path shape beside its bound (bounds.py), the
     plain version at the largest and the smallest; K2t at every
     transition key (pending words, absorbed words, pending outputs,
     squeezes) against its plain version run in lockstep over all keys on
     the CPU copy of the same inputs (its permutations run one after
     another, ~60 ms each on the card), timed beside its latency bound and,
     at its most launched key, its plain version;
  9. per path, the stage times and wall of one proof under the
     synchronising timer and its peak device memory; on the machine paths
     its stages beside the host-FS proof's of phase 5.

Prints each phase's seconds, a JSON line for the native library and per
path ("path": both flows' walls, synchronising operations and launches,
verify, synchronised wall, peak memory), the kernel table as one JSON line
(each kernel's largest shape, and every shape with its launches on each
path under "shapes"), then the card line, then
{"ok": true, "device": {...}} as the last line.
"""

import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
import warnings
from collections import Counter

import numpy as np
import torch

SEED = 2024
N_OPS = 128
PATHS = ("g1", "fq_exp", "g2")
COMPOSE_SEED = 123
COMPOSE_OPS = 2
TABLE_BITS = 16
H2G_SEED = 170
H2G_INPUTS = 4
MAX_TRANSITIONS = 16  # K2t launches a device-FS machine proof may take
MESH_PATH = "fq_exp"
MESH_RANKS = 4
MESH_KEYED_SEED = 21
# (name, machine, make_mesh2d shape or None for the 1-D mesh, prove keywords);
# the first proof meets cold tables
MESH_CASES = (
    ("1-D host FS", "fq_exp", None, {}),
    ("1-D host FS again", "fq_exp", None, {}),
    ("1-D device FS", "fq_exp", None, {"device_fs": True}),
    ("(2, 2) rows over (tp, dp)", "fq_exp", (2, 2), {"mesh_axis": ("tp", "dp")}),
    ("(2, 2) rows over dp, columns over tp", "fq_exp", (2, 2),
     {"mesh_axis": "dp", "col_axis": "tp"}),
    ("keyed_demo (2, 2) rows over dp, columns over tp", "keyed_demo", (2, 2),
     {"mesh_axis": "dp", "col_axis": "tp"}),
)
MESH_TIMEOUT_S = 500

KERNELS = {
    "K1": ("hash_leaves", "plonky2_bn254_tpu_torch/csrc/poseidon.cu",
           "plonky2_bn254_tpu/field/poseidon_pallas.py:385"),
    "K2": ("permute_states", "plonky2_bn254_tpu_torch/csrc/poseidon.cu",
           "plonky2_bn254_tpu/field/poseidon_pallas.py:457"),
    # K2's transcript use, redesigned: one launch per transition
    "K2t": ("sponge_transition", "plonky2_bn254_tpu_torch/csrc/poseidon.cu",
            "plonky2_bn254_tpu/field/poseidon_pallas.py:457"),
    "K3": ("intt", "plonky2_bn254_tpu_torch/csrc/ntt.cu",
           "plonky2_bn254_tpu/field/ntt_pallas.py:170"),
    "K4": ("coset_lde", "plonky2_bn254_tpu_torch/csrc/ntt.cu",
           "plonky2_bn254_tpu/field/ntt_pallas.py:240"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def rand_residues(rng, shape, device):
    from plonky2_bn254_tpu_torch.field import goldilocks as gl
    from plonky2_bn254_tpu_torch.interop import tensor_from_u64

    return tensor_from_u64(rng.integers(0, gl.P, size=shape, dtype=np.uint64), device)


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest |got - want| over the u64 values that the int64 tensors hold."""
    if got.numel() == 0:
        return 0
    flip = -(1 << 63)  # xor with the sign bit: unsigned order becomes signed order
    a, b = got ^ flip, want ^ flip
    diff = torch.maximum(a, b) - torch.minimum(a, b)  # wraps to the u64 difference
    return (int((diff ^ flip).max()) ^ flip) % (1 << 64)


def cuda_ms(fn, reps: int, warm_up: bool = True) -> float:
    """Mean device time of `fn` over `reps` runs, after one warm-up run
    (warm_up=False: the caller just ran it)."""
    if warm_up:
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def count_syncs(fn):
    """(fn(), Counter of "file:line" -> synchronising CUDA operations made
    there) under torch.cuda's sync debug mode: every device-to-host copy,
    every read of a device value, and every blocking host-to-device copy."""
    root = os.path.dirname(os.path.abspath(__file__))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = Counter(f"{os.path.relpath(w.filename, root)}:{w.lineno}" for w in caught
                    if "synchroniz" in str(w.message))
    return result, sites


def native_check() -> dict:
    """The host Poseidon library (field/native.py, built with g++ at first
    use) against the python versions on random words and the edge words 0,
    1, p - 1 and p; verify_path on a real tree, and with a flipped sibling."""
    from plonky2_bn254_tpu_torch.field import goldilocks as gl
    from plonky2_bn254_tpu_torch.field import native, poseidon
    from plonky2_bn254_tpu_torch.prover.merkle import MerkleTree, build_tree

    t0 = time.perf_counter()
    lib = native.library()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    edge = [0, 1, gl.P - 1, gl.P]
    states = rng.integers(0, 2**64 - 1, size=(256, 12), dtype=np.uint64, endpoint=True)
    states = [[int(v) for v in row] for row in states]
    for i, e in enumerate(edge):
        states[i] = [e] * 12
        for j in range(12):
            states[4 + 12 * i + j][j] = e
    for s in states:
        n = int(rng.integers(0, 30))
        if (poseidon.h_permute(s) != poseidon.h_permute_plain(s)
                or poseidon.h_hash_no_pad((s * 3)[:n]) != poseidon.h_hash_no_pad_plain((s * 3)[:n])
                or poseidon.h_two_to_one(s[:4], s[4:8]) != poseidon.h_two_to_one_plain(s[:4], s[4:8])):
            raise AssertionError(f"native Poseidon differs from the python version at {s}")
    leaves = rand_residues(rng, (256, 13), "cpu")
    tree = build_tree(leaves, cap_height=4)
    for index in (0, 77, 255):
        digest, path = tree.levels[0][index], tree.prove(index)
        if not MerkleTree.verify(digest, index, path, tree.cap):
            raise AssertionError(f"verify_path rejected the real path of leaf {index}")
        bad = [p.copy() for p in path]
        bad[1][2] ^= 1
        if MerkleTree.verify(digest, index, bad, tree.cap):
            raise AssertionError(f"verify_path accepted a flipped sibling at leaf {index}")
    reps = 2000
    t0 = time.perf_counter()
    for _ in range(reps):
        poseidon.h_permute(states[-1])
    native_us = (time.perf_counter() - t0) / reps * 1e6
    t0 = time.perf_counter()
    for _ in range(reps // 20):
        poseidon.h_permute_plain(states[-1])
    plain_us = (time.perf_counter() - t0) / (reps // 20) * 1e6
    log(f"  built in {build_s:.2f} s -> {lib._name}; permute, hash_no_pad, two_to_one equal "
        f"the python versions on {len(states)} states (edge words 0, 1, p-1, p among them); "
        f"verify_path accepts real paths, rejects flipped siblings; one permutation "
        f"{native_us:.1f} us native, {plain_us:.1f} us python")
    return {"build_s": build_s, "permute_us": native_us, "permute_plain_us": plain_us}


def clock_max_mhz() -> float:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return float(res.stdout.strip().splitlines()[0])


def kernel_call(kid: str, key: tuple):
    """(wrapper, plain version, (ops, bytes), input shape) of one launch key
    as the wrappers record it in kernels.CALLS."""
    from plonky2_bn254_tpu_torch import bounds
    from plonky2_bn254_tpu_torch.field import ntt_cuda, poseidon_cuda as pc

    if kid == "K1":
        return pc.hash_leaves, pc.hash_leaves_plain, bounds.hash_leaves_work(*key), key
    if kid == "K2":
        return (pc.permute_states, pc.permute_states_plain,
                bounds.permute_states_work(key[0]), (key[0], 12))
    rows, n, out_n, inverse = key
    if kid == "K3":
        kern, plain = (ntt_cuda.intt, ntt_cuda.intt_plain) if inverse else (ntt_cuda.ntt, ntt_cuda.ntt_plain)
        return kern, plain, bounds.ntt_work(rows, n, inverse), (rows, n)
    rate = (out_n // n).bit_length() - 1
    return (lambda x: ntt_cuda.coset_lde(x, rate), lambda x: ntt_cuda.coset_lde_plain(x, rate),
            bounds.coset_lde_work(rows, n, rate), (rows, n))


# Sizes beside the main path's, as launch keys: edge widths, n = 1, n = 2^20,
# the forward NTT, the LDE at rate 2.
ODD_KEYS = {
    "K1": [(1, 781), (5, 13), (3, 0)],
    "K2": [(1,)],
    # (pending, absorbed, pending outputs, squeezes): pending 0 and 7, an
    # empty absorb, squeeze-only, more than 8 squeezes, a 9,000-word absorb
    "K2t": [(0, 0, 0, 1), (7, 0, 0, 2), (7, 1, 0, 1), (0, 0, 5, 3), (0, 0, 5, 12),
            (2, 0, 0, 0), (0, 9000, 0, 1)],
    "K3": [(5, 8, 8, True), (13, 1 << 12, 1 << 12, True), (3, 1 << 20, 1 << 20, True),
           (1, 1, 1, True), (7, 1 << 17, 1 << 17, False)],
    "K4": [(5, 8, 16, False), (1, 1, 2, False), (7, 1 << 12, 1 << 14, False),
           (3, 1 << 16, 1 << 18, False)],
}


def k2t_inputs(rng, key: tuple, device) -> tuple:
    """(state, pending words, vectors) of one K2t launch key: the absorbed
    words as three device vectors, one of them empty, with two words passed
    by value between them where there are enough."""
    from plonky2_bn254_tpu_torch.interop import u64_from_tensor

    n_pending, n_words, _, _ = key
    state = rand_residues(rng, (12,), device)
    pending = rand_residues(rng, (n_pending,), device) if n_pending else None
    words = rand_residues(rng, (n_words,), device)
    cut = n_words // 3
    by_value = [int(v) for v in u64_from_tensor(words[cut : cut + 2])]
    return state, pending, [words[:cut], words[:0], *by_value, words[cut + 2 :]]


def k2t_plain_lockstep(states, streams, n_outs, n_squeezes) -> tuple:
    """K2t's plain version in lockstep over all keys on the CPU (numpy in
    and out, for a worker process): (per key [state, leftover, outputs],
    seconds)."""
    from plonky2_bn254_tpu_torch.field import poseidon_cuda as pc

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    out = pc.sponge_transitions_plain(torch.from_numpy(states), [torch.from_numpy(w) for w in streams],
                                      n_outs, n_squeezes)
    return [[t.numpy() for t in row] for row in out], time.perf_counter() - t0


def start_k2t(device, calls_by_path: dict, sms: int, clock_mhz: float, pool):
    """K2t at every transition key any path recorded and at ODD_KEYS: the
    kernel's results, its plain version in lockstep over all keys on the
    CPU copy of the same inputs handed to `pool` (it runs while the other
    kernels are compared), each path key timed beside its latency bound
    (bounds.py), the plain version on the card at the most launched.
    Returns the check that waits for the plain results and compares."""
    from plonky2_bn254_tpu_torch import bounds
    from plonky2_bn254_tpu_torch.field import poseidon_cuda as pc

    rng = np.random.default_rng(SEED)
    calls = Counter()
    for per_path in calls_by_path.values():
        calls.update(per_path["K2t"])
    timed = sorted(calls, key=lambda k: bounds.sponge_transition_work(k)[2], reverse=True)
    keys = timed + [k for k in ODD_KEYS["K2t"] if k not in calls]
    inputs = [k2t_inputs(rng, key, device) for key in keys]
    got = [[t.cpu() for t in pc.sponge_transition(st, pe, vs, key[3], key[2])]
           for key, (st, pe, vs) in zip(keys, inputs)]
    on_cpu = lambda vs: [v.cpu() if isinstance(v, torch.Tensor) else v for v in vs]
    pending = pool.apply_async(k2t_plain_lockstep, (
        torch.stack([st.cpu() for st, _, _ in inputs]).numpy(),
        [pc.stream_words(None if pe is None else pe.cpu(), on_cpu(vs), "cpu").numpy()
         for _, pe, vs in inputs],
        [k[2] for k in keys], [k[3] for k in keys]))

    launched = lambda k: sum(calls_by_path[p]["K2t"].get(k, 0) for p in calls_by_path)
    main_key = max(timed, key=lambda k: (launched(k), bounds.sponge_transition_work(k)[2]))
    chain = bounds.permutation_latency()
    rows, main = [], None
    for key, (st, pe, vs) in zip(timed, inputs):
        ops, nbytes, perms, chain_cycles = bounds.sponge_transition_work(key)
        ms = cuda_ms(lambda: pc.sponge_transition(st, pe, vs, key[3], key[2]), reps=10)
        plain_ms = (cuda_ms(lambda: pc.sponge_transition_plain(st, pe, vs, key[3], key[2]), reps=1)
                    if key == main_key else None)
        bound, bound_by = bounds.bound_ms(ops, nbytes, sms, clock_mhz, chain_cycles)
        per_path = {p: calls_by_path[p]["K2t"].get(key, 0) for p in calls_by_path}
        row = {"key": list(key), "launches": per_path, "perms": perms, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound,
               "bound_by": bound_by, "share": bound / ms,
               "us_per_perm": 1e3 * ms / perms if perms else None}
        rows.append(row)
        main = row if key == main_key else main
        log(f"  K2t {key} x{launched(key)}: {perms} permutations, kernel {ms:.4f} ms"
            + (f" ({row['us_per_perm']:.2f} us a permutation)" if perms else "")
            + f", latency bound {bound:.4f} ms, share {bound / ms:.3f}"
            + (f", plain {plain_ms:.3f} ms" if plain_ms is not None else ""))

    def check() -> dict:
        want, plain_s = pending.get(timeout=900)
        err = 0
        for key, g, w in zip(keys, got, want):
            g, w = torch.cat(g), torch.cat([torch.from_numpy(t) for t in w])
            err = max(err, max_abs_err(g, w))
            if not torch.equal(g, w):
                raise AssertionError(f"K2t {key}: {int((g != w).sum())} words differ from the plain version")
        log(f"  K2t: equal to plain at {len(timed)} path and {len(keys) - len(timed)} odd keys, "
            f"max_abs_err {err} (plain in lockstep on the CPU, in a worker process: {plain_s:.1f} s)")
        return {"max_abs_err": err, "timed": rows, "main": main, "plain_lockstep_s": plain_s,
                "permutation_latency_cycles": chain}

    return check


def compare_kernels(device, calls_by_path: dict, sms: int, clock_mhz: float) -> dict:
    """Each kernel vs its plain version on the card at every key any path
    launched it with (timed, beside the bound of bounds.py) and at
    ODD_KEYS.  Raises on the first disagreement."""
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        k2t_check = start_k2t(device, calls_by_path, sms, clock_mhz, pool)
        results = compare_k1_to_k4(device, calls_by_path, sms, clock_mhz)
        results["K2t"] = k2t_check()
    return results


def compare_k1_to_k4(device, calls_by_path: dict, sms: int, clock_mhz: float) -> dict:
    """K1-K4 against their plain versions on the card (see compare_kernels)."""
    from plonky2_bn254_tpu_torch import bounds

    rng = np.random.default_rng(SEED)
    results = {}
    for kid, odd in ODD_KEYS.items():
        if kid == "K2t":
            continue
        calls = Counter()
        for per_path in calls_by_path.values():
            calls.update(per_path[kid])
        timed = sorted(calls, key=lambda k: kernel_call(kid, k)[2], reverse=True)
        err, rows = 0, []
        for i, key in enumerate(timed + [k for k in odd if k not in calls]):
            kern, plain, work, shape = kernel_call(kid, key)
            x = rand_residues(rng, shape, device)
            got = kern(x)
            want = plain(x)  # also the warm-up of the plain timing below
            torch.cuda.synchronize()
            err = max(err, max_abs_err(got, want))
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                raise AssertionError(f"{kid} {key}: {bad} elements differ from the plain version")
            del got, want
            if i < len(timed):
                ms = cuda_ms(lambda: kern(x), reps=20)
                plain_ms = (cuda_ms(lambda: plain(x), reps=1, warm_up=False)
                            if i in (0, len(timed) - 1) else None)
                bound, bound_by = bounds.bound_ms(*work, sms, clock_mhz)
                per_path = {p: calls_by_path[p][kid].get(key, 0) for p in calls_by_path}
                rows.append({"key": list(key), "launches": per_path, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                             "share": bound / ms})
                log(f"  {kid} {key} x{per_path}: kernel {ms:.3f} ms, bound {bound:.4f} ms "
                    f"({bound_by}), share {bound / ms:.3f}"
                    + (f", plain {plain_ms:.3f} ms" if plain_ms is not None else ""))
            del x
        n_odd = len([k for k in odd if k not in calls])
        log(f"  {kid}: equal to plain at {len(timed)} path and {n_odd} odd shapes, "
            f"max_abs_err {err}")
        results[kid] = {"max_abs_err": err, "timed": rows}
        torch.cuda.empty_cache()
    return results


def demo_matches_cpu(device) -> None:
    """The demo STARK proved on the card equals its proof on the CPU."""
    from plonky2_bn254_tpu_torch.interop import proof_to_fields
    from plonky2_bn254_tpu_torch.prover import prove as prove_mod
    from plonky2_bn254_tpu_torch.prover import verify as verify_mod
    from plonky2_bn254_tpu_torch.prover.config import TEST_CONFIG
    from plonky2_bn254_tpu_torch.starks.demo import demo_stark, demo_trace

    trace, ctl = demo_trace(np.random.default_rng(SEED))
    on_card = prove_mod.prove(demo_stark(), trace.to(device), ctl, TEST_CONFIG)
    on_cpu = prove_mod.prove(demo_stark(), trace, ctl, TEST_CONFIG)
    verify_mod.verify(demo_stark(), on_card, ctl, TEST_CONFIG)
    a, b = proof_to_fields(on_card), proof_to_fields(on_cpu)
    if json.dumps(a, default=lambda v: v.tolist()) != json.dumps(b, default=lambda v: v.tolist()):
        raise AssertionError("demo proof on the card differs from the CPU proof")


class Path:
    """One of the three machines, driven through its public entry points:
    generate_trace, prove, verify."""

    def __init__(self, name: str, device):
        from plonky2_bn254_tpu_torch.bn254 import oracle
        from plonky2_bn254_tpu_torch.starks import fq_exp, g1_scalar_mul, g2_scalar_mul, table

        self.name, self.device = name, device
        self.module, self.stark = {
            "g1": (g1_scalar_mul, table.g1_scalar_mul_stark()),
            "fq_exp": (fq_exp, table.fq_exp_stark()),
            "g2": (g2_scalar_mul, table.g2_scalar_mul_stark()),
        }[name]
        rng = np.random.default_rng(SEED)

        def scalar():
            return int(rng.integers(1, 1 << 63)) << 192 | int(rng.integers(0, 1 << 63))

        if name == "fq_exp":
            self.inputs = [(scalar(), oracle.random_fq(rng), t) for t in range(N_OPS)]
        else:
            point = oracle.random_g1 if name == "g1" else oracle.random_g2
            self.inputs = [(scalar(), point(rng), point(rng), t) for t in range(N_OPS)]
        self.ctl_values = self.module.generate_ctl_values(self.inputs)

    def trace(self):
        trace = self.module.generate_trace(self.inputs, device=self.device)
        assert trace.shape == (1 << 16, self.stark.width), trace.shape
        return trace

    def prove_trace(self, trace, tt=None, device_fs=None):
        from plonky2_bn254_tpu_torch.prover import prove as prove_mod
        from plonky2_bn254_tpu_torch.prover.config import DEFAULT_CONFIG

        return prove_mod.prove(self.stark, trace, self.ctl_values, DEFAULT_CONFIG, timing=tt,
                               device_fs=device_fs)

    def prove(self, tt=None):
        from plonky2_bn254_tpu_torch.utils.timing import TimingTree

        tt = tt or TimingTree(enabled=False)
        with tt.scope("trace gen"):
            trace = self.trace()
        return self.prove_trace(trace, tt)

    def verify(self, proof):
        from plonky2_bn254_tpu_torch.prover import verify as verify_mod
        from plonky2_bn254_tpu_torch.prover.config import DEFAULT_CONFIG

        verify_mod.verify(self.stark, proof, self.ctl_values, DEFAULT_CONFIG)


def gb(nbytes: int) -> float:
    return nbytes / 1e9


def flow_run(path: Path, trace, device_fs: bool):
    """One proof of `trace` in one Fiat–Shamir flow, with the launch counts
    set to 0 just before and read just after: (proof, record) with its
    synchronised wall, its synchronising operations by site and its
    launches; fails unless every kernel launched (K2t, the device
    transcript's transitions, only in the device flow, at most
    MAX_TRANSITIONS times) and K2 never at [1, 12]."""
    from plonky2_bn254_tpu_torch import kernels

    flow = "device FS" if device_fs else "host FS"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(path.device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    proof, sites = count_syncs(lambda: path.prove_trace(trace, device_fs=device_fs))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    calls = {k: dict(kernels.CALLS[k]) for k in kernels.KERNEL_IDS}
    k2_single = calls["K2"].get((1,), 0)
    peak = gb(torch.cuda.max_memory_allocated(path.device))
    log(f"  {flow}: synchronised wall {wall:.3f} s; {sum(sites.values())} synchronising "
        f"operations {dict(sites.most_common())}; launches {launches}, K2 at [1, 12] "
        f"{k2_single}, K2t {launches['K2t']}; peak device memory {peak:.2f} GB")
    missing = [k for k in kernels.KERNEL_IDS if launches[k] <= 0 and (device_fs or k != "K2t")]
    if missing:
        raise AssertionError(f"path {path.name} ({flow}) never launched {missing}")
    if k2_single or (launches["K2t"] > MAX_TRANSITIONS if device_fs else launches["K2t"]):
        raise AssertionError(f"path {path.name} ({flow}): K2 at [1, 12] {k2_single} times, "
                             f"K2t {launches['K2t']} times")
    return proof, {"wall_s": wall, "syncs": sum(sites.values()), "sync_sites": dict(sites),
                   "launches": launches, "k2_single_launches": k2_single,
                   "k2t_launches": launches["K2t"], "peak_gb": peak, "calls": calls}


def flow_stages(path: Path, trace, device_fs: bool) -> dict:
    """Top-level stage times of one proof of `trace` in one Fiat–Shamir
    flow under the synchronising timer (the host flow's transcript work
    falls between its stages; the device flow's is in fs1-fs4), with
    "proof" the whole proof."""
    from plonky2_bn254_tpu_torch.utils.timing import TimingTree

    tt = TimingTree(enabled=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path.prove_trace(trace, tt, device_fs=device_fs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {**{stage: secs for depth, stage, secs in tt.records if depth == 0}, "proof": wall}


def first_proof(path: Path) -> dict:
    """Trace the path's inputs once; prove the trace with the transcript on
    the device (the default on the card), on the host and on the device
    again; the proofs equal field by field; the stages of one more host-FS
    proof under the synchronising timer (phase 9 sets them beside the
    device flow's); the device-FS proof verifies, and is rejected with one
    opening flipped."""
    from plonky2_bn254_tpu_torch.field.extension import GLExt
    from plonky2_bn254_tpu_torch.interop import proof_to_fields
    from plonky2_bn254_tpu_torch.prover import verify as verify_mod

    log(f"# path {path.name}: {N_OPS} ops, 2^16 x {path.stark.width} trace, DEFAULT_CONFIG")
    t0 = time.perf_counter()
    trace = path.trace()
    torch.cuda.synchronize()
    trace_s = time.perf_counter() - t0
    log(f"  trace gen {trace_s:.2f} s")
    # device, host, device: the first proof of a path meets cold tables
    dev_proof, dev_run = flow_run(path, trace, device_fs=True)
    host_proof, host_run = flow_run(path, trace, device_fs=False)
    warm_proof, warm_run = flow_run(path, trace, device_fs=True)
    as_json = lambda p: json.dumps(proof_to_fields(p), default=lambda v: v.tolist())
    if not as_json(dev_proof) == as_json(host_proof) == as_json(warm_proof):
        raise AssertionError(f"path {path.name}: the device-FS proof differs from the host-FS proof")
    log("  device-FS proofs equal the host-FS proof field by field")
    host_stages = flow_stages(path, trace, device_fs=False)
    if path.name == MESH_PATH:
        path.mesh_trace, path.host_fs_json = trace, as_json(host_proof)

    t0 = time.perf_counter()
    path.verify(dev_proof)
    verify_s = time.perf_counter() - t0
    log(f"  device-FS proof verified in {verify_s:.2f} s (host verifier, native Poseidon)")
    dev_proof.openings.trace_zeta[0] = dev_proof.openings.trace_zeta[0] + GLExt(1)
    try:
        path.verify(dev_proof)
    except verify_mod.VerificationError as e:
        log(f"  tampered proof rejected: {e}")
    else:
        raise AssertionError(f"path {path.name}: a proof with a flipped opening was accepted")
    return {"trace_gen_s": trace_s, "verify_s": verify_s, "host_fs_stages_s": host_stages,
            "device_fs": {k: v for k, v in dev_run.items() if k != "calls"},
            "host_fs": {k: v for k, v in host_run.items() if k != "calls"},
            "device_fs_again": {k: v for k, v in warm_run.items() if k != "calls"},
            "launches": dev_run["launches"], "calls": dev_run["calls"],
            "host_fs_calls": host_run["calls"]}


def mesh_rank(rank: int, world: int, trace_file: str, ctl_values, cases) -> dict:
    """One rank of the mesh phase, in a spawned process: the 1-D mesh and
    the (2, 2) mesh over ("tp", "dp") on the card's default device (every
    rank on cuda:0, gloo moving host tensors), then each of `cases` (see
    MESH_CASES) between two barriers with the launch counts set to 0 just
    before it and read just after; the device-FS proof's synchronising
    operations counted by site."""
    import torch.distributed as dist

    from plonky2_bn254_tpu_torch import kernels
    from plonky2_bn254_tpu_torch.interop import proof_to_fields
    from plonky2_bn254_tpu_torch.parallel.mesh import make_mesh, make_mesh2d
    from plonky2_bn254_tpu_torch.prover import prove as prove_mod
    from plonky2_bn254_tpu_torch.prover.config import DEFAULT_CONFIG, TEST_CONFIG
    from plonky2_bn254_tpu_torch.starks import demo, table
    from plonky2_bn254_tpu_torch.utils.timing import TimingTree

    meshes = {None: make_mesh(world), (2, 2): make_mesh2d((2, 2))}
    keyed_trace, keyed_ctl = demo.keyed_demo_trace(np.random.default_rng(MESH_KEYED_SEED))
    machines = {
        "fq_exp": (table.fq_exp_stark(), torch.from_numpy(np.load(trace_file, mmap_mode="c")),
                   ctl_values, DEFAULT_CONFIG),  # each rank reads its rows of the mapped trace
        "keyed_demo": (demo.keyed_demo_stark(), keyed_trace, keyed_ctl, TEST_CONFIG),
    }
    mesh = meshes[None]
    proofs = []
    for _, machine, shape, kw in cases:
        stark, trace, ctl, config = machines[machine]
        m = meshes[shape]
        tt = TimingTree(enabled=True)
        torch.cuda.synchronize(mesh.device)
        torch.cuda.reset_peak_memory_stats(mesh.device)
        m.reset_stats()
        dist.barrier()
        kernels.reset_launches()
        t0 = time.perf_counter()
        run = lambda: prove_mod.prove(stark, trace, ctl, config, timing=tt, mesh=m, **kw)
        proof, sites = count_syncs(run) if kw.get("device_fs") else (run(), Counter())
        torch.cuda.synchronize(mesh.device)
        launches = dict(kernels.LAUNCHES)
        calls = {k: dict(kernels.CALLS[k]) for k in kernels.KERNEL_IDS}
        dist.barrier()
        proofs.append({"wall_s": time.perf_counter() - t0, "scopes": tt.records,
                       "peak_gb": gb(torch.cuda.max_memory_allocated(mesh.device)),
                       "stats": m.stats, "launches": launches, "calls": calls,
                       "syncs": sum(sites.values()), "sync_sites": dict(sites),
                       "fields": proof_to_fields(proof)})
    return {"device": str(mesh.device), "backend": mesh.backend, "wire": str(mesh.wire),
            "proofs": proofs}


def mesh_model_bytes(stark_width: int, fields: dict, n_log: int, D: int) -> int:
    """Bytes one rank sends in the mesh transforms of a rate-1 proof by the
    reference's model, 3 * 8 * w * C * (D - 1) / D a transform (C its block):
    iNTT and the LDE's two NTTs of the trace and aux batches, the quotient's
    iNTT over the N = 2n coset, its halves' LDE."""
    n = 1 << n_log
    w_aux = len(fields["openings"]["aux_zeta"])
    w_q = len(fields["openings"]["quotient_zeta"])
    words = 3 * (stark_width + w_aux) * (n // D) + (w_q // 2) * (2 * n // D) + 2 * w_q * (n // D)
    return 3 * 8 * words * (D - 1) // D


def check_mesh_case(name: str, machine: str, kw: dict, ranks: list, i: int, want: str) -> None:
    """Case `i` on every rank: the single-device proof; K1, K2 and K3
    launched, K4 not, K2 never at [1, 12], K2t (at most MAX_TRANSITIONS
    times) only with the device transcript; the trace's columns split over
    tp (one gather there) only where its width divides."""
    device_fs = bool(kw.get("device_fs"))
    for r, res in enumerate(ranks):
        p = res["proofs"][i]
        if json.dumps(p["fields"], default=lambda v: v.tolist()) != want:
            raise AssertionError(f"mesh {name}, rank {r}: differs from the single-device proof")
        n = p["launches"]
        k2t_ok = 0 < n["K2t"] <= MAX_TRANSITIONS if device_fs else n["K2t"] == 0
        if (min(n["K1"], n["K2"], n["K3"]) <= 0 or n["K4"] or not k2t_ok
                or p["calls"]["K2"].get((1,), 0)):
            raise AssertionError(f"mesh {name}, rank {r}: launches {n}, K2 keys {p['calls']['K2']}")
        if "col_axis" in kw:
            tp = p["stats"]["by_axes"]["tp"]
            sharded = machine == "keyed_demo"  # width 6 splits over 2; fq_exp's 427 does not
            if (tp["gathers"], tp["bytes_sent"] > 0) != ((1, True) if sharded else (0, False)):
                raise AssertionError(f"mesh {name}, rank {r}: tp stats {tp}")


def mesh_phase(path, single: dict, card: str) -> dict:
    """The mesh phase (5m of the module docstring); `single`: the path's
    first_proof record.  Fails unless every case's proof on every rank
    equals its single-device proof, verifies, is rejected with one opening
    flipped, and launched what check_mesh_case asks."""
    from plonky2_bn254_tpu_torch.field.extension import GLExt
    from plonky2_bn254_tpu_torch.interop import proof_from_fields, proof_to_fields
    from plonky2_bn254_tpu_torch.parallel import launch
    from plonky2_bn254_tpu_torch.prover import prove as prove_mod
    from plonky2_bn254_tpu_torch.prover import verify as verify_mod
    from plonky2_bn254_tpu_torch.prover.config import TEST_CONFIG
    from plonky2_bn254_tpu_torch.starks import demo

    log(f"# mesh: {path.name} 2^16 x {path.stark.width} at DEFAULT_CONFIG and keyed_demo at "
        f"TEST_CONFIG on {MESH_RANKS} gloo ranks sharing the card ({card})")
    keyed_trace, keyed_ctl = demo.keyed_demo_trace(np.random.default_rng(MESH_KEYED_SEED))
    keyed = demo.keyed_demo_stark()
    keyed_single = prove_mod.prove(keyed, keyed_trace.to(path.device), keyed_ctl, TEST_CONFIG)
    want = {"fq_exp": path.host_fs_json,
            "keyed_demo": json.dumps(proof_to_fields(keyed_single), default=lambda v: v.tolist())}

    def verify(machine, proof):
        if machine == "fq_exp":
            path.verify(proof)
        else:
            verify_mod.verify(keyed, proof, keyed_ctl, TEST_CONFIG)

    with tempfile.TemporaryDirectory() as tmp:
        trace_file = os.path.join(tmp, "trace.npy")
        np.save(trace_file, path.mesh_trace.cpu().numpy())
        del path.mesh_trace
        t0 = time.perf_counter()
        ranks = launch.run(mesh_rank, MESH_RANKS, trace_file, path.ctl_values, MESH_CASES,
                           timeout=MESH_TIMEOUT_S)
        spawn_to_end = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        if (res["device"], res["backend"], res["wire"]) != ("cuda:0", "gloo", "cpu"):
            raise AssertionError(f"mesh rank {r}: {res['device']}, {res['backend']}, {res['wire']}")
    single_peak_gb = single["host_fs"]["peak_gb"]
    log(f"  spawn to last result {spawn_to_end:.1f} s; the single-device host-FS proof "
        f"{single['host_fs_stages_s']['proof']:.3f} s (synchronised stages), peak "
        f"{single_peak_gb:.2f} GB")
    records = []
    for i, (name, machine, shape, kw) in enumerate(MESH_CASES):
        check_mesh_case(name, machine, kw, ranks, i, want[machine])
        proof = proof_from_fields(ranks[0]["proofs"][i]["fields"])
        verify(machine, proof)
        proof.openings.trace_zeta[0] = proof.openings.trace_zeta[0] + GLExt(1)
        try:
            verify(machine, proof)
        except verify_mod.VerificationError:
            pass
        else:
            raise AssertionError(f"mesh {name}: a proof with a flipped opening was accepted")
        per_rank = [res["proofs"][i] for res in ranks]
        rec = {"case": name, "machine": machine, "wall_s": max(p["wall_s"] for p in per_rank),
               "peak_gb_per_rank": [p["peak_gb"] for p in per_rank],
               "bytes_sent_per_rank": [p["stats"]["bytes_sent"] for p in per_rank],
               "launches_per_rank": [p["launches"] for p in per_rank]}
        if "by_axes" in per_rank[0]["stats"]:
            rec["bytes_sent_by_axes_rank0"] = {k: v["bytes_sent"] for k, v in
                                               per_rank[0]["stats"]["by_axes"].items()}
        if kw.get("device_fs"):
            rec["syncs_per_rank"] = [p["syncs"] for p in per_rank]
            rec["sync_sites_rank0"] = per_rank[0]["sync_sites"]
        records.append(rec)
        top = {stage: secs for depth, stage, secs in per_rank[0]["scopes"] if depth == 0}
        log(f"  {name}: equal to the single-device proof on every rank, verified, rejected with "
            f"an opening flipped; wall (barrier to barrier) {rec['wall_s']:.3f} s; peak per rank "
            f"{[round(x, 2) for x in rec['peak_gb_per_rank']]} GB; bytes sent per rank "
            f"{rec['bytes_sent_per_rank']}; launches rank 0 {rec['launches_per_rank'][0]}")
        log("    rank 0 stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in top.items()))
        if "bytes_sent_by_axes_rank0" in rec:
            log(f"    bytes sent by rank 0 over each axis {rec['bytes_sent_by_axes_rank0']}")
        if "col_axis" in kw:
            width = keyed.width if machine == "keyed_demo" else path.stark.width
            log(f"    columns over tp: width {width} % 2 = {width % 2}: "
                + ("sharded, one gather over tp" if width % 2 == 0
                   else "replicated, nothing sent over tp"))
        if "syncs_per_rank" in rec:
            log(f"    synchronising operations per rank {rec['syncs_per_rank']}; rank 0 by site "
                f"{dict(Counter(rec['sync_sites_rank0']).most_common())}")
    first = [res["proofs"][0] for res in ranks]
    model = mesh_model_bytes(path.stark.width, first[0]["fields"], 16, MESH_RANKS)
    log(f"  1-D host FS: bytes sent per rank {records[1]['bytes_sent_per_rank']}; the reference's "
        f"model of the mesh transforms {model} per rank")
    launches = Counter()
    calls = {k: Counter() for k in first[0]["calls"]}
    for res in ranks:
        for p in res["proofs"]:
            launches.update(p["launches"])
            for k, per_key in p["calls"].items():
                calls[k].update(per_key)
    return {"ranks": MESH_RANKS, "cases": records, "spawn_to_end_s": spawn_to_end,
            "scopes_s_1d_host_fs": ranks[0]["proofs"][1]["scopes"],
            "single_device_peak_gb": single_peak_gb, "model_transform_bytes_per_rank": model,
            "launches": {k: launches[k] for k in first[0]["launches"]},
            "calls": {k: dict(v) for k, v in calls.items()}}


class Compose:
    """The compose path: fq_exp ops on a CircuitBuilder, driven through the
    circuit API a user calls (build, generate_witness, outer_data,
    prove_outer, verify_all)."""

    name = "compose"

    def __init__(self, device):
        from plonky2_bn254_tpu_torch.bn254 import oracle, params
        from plonky2_bn254_tpu_torch.circuit import builder_ops
        from plonky2_bn254_tpu_torch.circuit.builder import CircuitBuilder, Witness
        from plonky2_bn254_tpu_torch.circuit.fq import FqTarget
        from plonky2_bn254_tpu_torch.prover.config import DEFAULT_CONFIG

        self.device = device
        rng = np.random.default_rng(COMPOSE_SEED)
        t0 = time.perf_counter()
        builder = CircuitBuilder()
        self.hook = builder_ops.get_bn254_hook(builder)
        self.hook.stark_config = DEFAULT_CONFIG
        self.pw = Witness()
        self.outs = []
        for _ in range(COMPOSE_OPS):
            x_t = FqTarget.new_unchecked(builder)
            s_v = int(rng.integers(1, 1 << 62)) << 150 | int(rng.integers(0, 1 << 62))
            x_v = oracle.random_fq(rng)
            out_t = builder_ops.fq_exp(builder, s_v, x_t)
            x_t.set_witness(self.pw, x_v)
            self.outs.append((out_t, pow(x_v, s_v, params.P)))
        for t in self.outs[0][0].value.limbs:
            builder.register_public_input(t)
        self.circuit = builder.build()
        self.build_s = time.perf_counter() - t0
        log(f"# path compose: build {self.build_s:.2f} s, "
            f"{self.circuit.builder.num_targets:,} targets, "
            f"{len(self.circuit.builder.poseidon_ops):,} Poseidon ops")

    def witness(self) -> dict:
        from plonky2_bn254_tpu_torch import kernels
        from plonky2_bn254_tpu_torch.utils.timing import TimingTree

        self.hook.timing = TimingTree(enabled=True)
        kernels.reset_launches()
        t0 = time.perf_counter()
        self.values = self.circuit.generate_witness(self.pw, self.device)
        torch.cuda.synchronize()
        witness_s = time.perf_counter() - t0
        calls = {k: dict(kernels.CALLS[k]) for k in kernels.KERNEL_IDS}
        stages = {stage: secs for _, stage, secs in self.hook.timing.records}
        for out_t, want in self.outs:
            if out_t.get_witness(self.values) != want:
                raise AssertionError("compose: an fq_exp output differs from pow(x, s, P)")
        k2_single, k2t = calls["K2"].get((1,), 0), kernels.LAUNCHES["K2t"]
        log(f"  witness {witness_s:.2f} s (inner FqExp proof on the card + self-verify + "
            f"fixpoint); " + ", ".join(f"{k} {v:.2f} s" for k, v in stages.items())
            + f"; K2 at [1, 12] {k2_single}, K2t {k2t}")
        if k2_single or not 0 < k2t <= MAX_TRANSITIONS:
            raise AssertionError(f"compose witness: K2 at [1, 12] {k2_single} times, K2t {k2t}")
        log(f"  outputs equal pow(x, s, P) for all {COMPOSE_OPS} ops")
        return {"witness_s": witness_s, "witness_stages_s": stages, "witness_calls": calls}

    def compile(self) -> dict:
        from plonky2_bn254_tpu_torch import kernels

        kernels.reset_launches()
        t0 = time.perf_counter()
        self.data = self.circuit.outer_data(TABLE_BITS, self.device)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        lay = self.data.lay
        log(f"  compile_outer {compile_s:.2f} s: outer_rows_log2 {self.data.n_log}, width "
            f"{lay.width} (R {lay.R}), {self.data.n_gate_rows:,} gate rows, "
            f"{self.data.n_pos:,} Poseidon blocks, {self.data.n_wires:,} wires")
        return {"compile_outer_s": compile_s, "outer_rows_log2": self.data.n_log,
                "outer_width": lay.width,
                "compile_calls": {k: dict(kernels.CALLS[k]) for k in kernels.KERNEL_IDS}}

    def prove(self, tt=None):
        from plonky2_bn254_tpu_torch.circuit import outer
        from plonky2_bn254_tpu_torch.prover.config import DEFAULT_CONFIG

        proof, publics = outer.prove_outer(self.data, self.values, DEFAULT_CONFIG, timing=tt)
        self.publics = publics
        return proof

    def prove_with(self, device_fs: bool):
        """The outer proof as prove_outer makes it, with the transcript
        chosen: the outer trace, then prove."""
        from plonky2_bn254_tpu_torch.circuit import outer
        from plonky2_bn254_tpu_torch.prover import prove as prove_mod
        from plonky2_bn254_tpu_torch.prover.config import DEFAULT_CONFIG

        trace, _, ctl_values = outer.build_outer_trace(self.data, self.values)
        return prove_mod.prove(self.data.stark, trace, ctl_values, DEFAULT_CONFIG,
                               device_fs=device_fs)

    def verify(self, proof, publics):
        from plonky2_bn254_tpu_torch.prover.config import DEFAULT_CONFIG

        self.circuit.verify_all(proof, publics, DEFAULT_CONFIG, TABLE_BITS, self.device)


def compose_first_proof(path: Compose) -> dict:
    """build -> witness -> compile_outer -> the first outer proof (launch
    counts set to 0 just before it and read just after) -> verify_all, and
    a corrupted public value and a flipped opening rejected; then the outer
    proof with the host transcript and with the device one again, both
    equal to the first field by field, each with its synchronised wall."""
    from plonky2_bn254_tpu_torch import interop, kernels
    from plonky2_bn254_tpu_torch.field.extension import GLExt
    from plonky2_bn254_tpu_torch.prover import verify as verify_mod

    res = {"build_s": path.build_s, "targets": path.circuit.builder.num_targets}
    res.update(path.witness())
    res.update(path.compile())
    torch.cuda.reset_peak_memory_stats(path.device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    proof = path.prove()
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    calls = {k: dict(kernels.CALLS[k]) for k in kernels.KERNEL_IDS}
    peak = gb(torch.cuda.max_memory_allocated(path.device))
    k2_single = calls["K2"].get((1,), 0)
    log(f"  first outer proof {prove_s:.2f} s (device transcript); launches {launches}, "
        f"K2 at [1, 12] {k2_single}, K2t {launches['K2t']}; peak device memory {peak:.2f} GB")
    missing = [k for k in kernels.KERNEL_IDS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"path compose never launched {missing} on the outer proof")
    if k2_single or launches["K2t"] > MAX_TRANSITIONS:
        raise AssertionError(f"compose outer proof: K2 at [1, 12] {k2_single} times, "
                             f"K2t {launches['K2t']}")

    statement = sum(v << (32 * i) for i, v in enumerate(path.publics))
    if statement != path.outs[0][1]:
        raise AssertionError("compose: the public statement differs from pow(x, s, P)")
    t0 = time.perf_counter()
    path.verify(proof, path.publics)
    verify_s = time.perf_counter() - t0
    log(f"  verify_all accepted in {verify_s:.2f} s; public statement = x^s mod p")
    bad = list(path.publics)
    bad[0] = (bad[0] + 1) % ((1 << 64) - (1 << 32) + 1)
    flipped = interop.proof_from_fields(interop.proof_to_fields(proof))
    flipped.openings.trace_zeta[0] = flipped.openings.trace_zeta[0] + GLExt(1)
    for what, tampered, publics in (("corrupted public value", proof, bad),
                                    ("flipped opening", flipped, path.publics)):
        try:
            path.verify(tampered, publics)
        except verify_mod.VerificationError as e:
            log(f"  {what} rejected: {e}")
        else:
            raise AssertionError(f"compose: a proof with a {what} was accepted")
    fields = json.dumps(interop.proof_to_fields(proof), default=lambda v: v.tolist())
    walls = {}
    for flow, device_fs in (("host FS", False), ("device FS again", True)):
        kernels.reset_launches()
        t0 = time.perf_counter()
        again = path.prove_with(device_fs)
        torch.cuda.synchronize()
        walls[flow] = time.perf_counter() - t0
        k2t = kernels.LAUNCHES["K2t"]
        log(f"  outer proof, {flow}: {walls[flow]:.2f} s, K2t {k2t}")
        if json.dumps(interop.proof_to_fields(again), default=lambda v: v.tolist()) != fields:
            raise AssertionError(f"compose: the outer proof with {flow} differs from the first")
        if (k2t > 0) != device_fs:
            raise AssertionError(f"compose: the outer proof with {flow} took {k2t} K2t launches")
    log(f"  outer proof walls: device FS {prove_s:.2f} s (first), host FS {walls['host FS']:.2f} s, "
        f"device FS again {walls['device FS again']:.2f} s; the proofs equal field by field")
    res.update({"first_proof_s": prove_s, "verify_s": verify_s, "first_peak_gb": peak,
                "launches": launches, "calls": calls,
                "host_fs_proof_s": walls["host FS"], "device_fs_again_s": walls["device FS again"]})
    return res


# The hook config of tests/test_torch_cuda.py::test_compose_three_kinds_on_card.
H2G_HOOK_CONFIG = dict(num_challenges=2, rate_bits=1, cap_height=1, proof_of_work_bits=8,
                       num_query_rounds=4, arity_bits=2, final_poly_degree_bits=3)


def hash_to_g2_phase(device) -> dict:
    """hash_to_g2_circuit over H2G_INPUTS field elements with the real
    backend on the card: the hook proves the is_square fq_exp ops and the
    blinded cofactor g2_scalar_mul at witness time (device FS) and
    self-verifies them; the output point's limbs are public; one outer proof
    at TEST_CONFIG; verify_all accepts it and rejects it with one opening
    flipped; the public point equals the native mirror hash_to_g2.  Launch
    counts are set to 0 before the phase and read after it."""
    from plonky2_bn254_tpu_torch import interop, kernels
    from plonky2_bn254_tpu_torch.circuit import builder_ops, outer
    from plonky2_bn254_tpu_torch.circuit import hash_to_g2 as h2g
    from plonky2_bn254_tpu_torch.circuit.builder import CircuitBuilder, Witness
    from plonky2_bn254_tpu_torch.field.extension import GLExt
    from plonky2_bn254_tpu_torch.prover import verify as verify_mod
    from plonky2_bn254_tpu_torch.prover.config import TEST_CONFIG, StarkConfig
    from plonky2_bn254_tpu_torch.utils.timing import TimingTree

    rng = np.random.default_rng(H2G_SEED)
    inputs = [int(rng.integers(0, 1 << 60)) for _ in range(H2G_INPUTS)]
    want = h2g.hash_to_g2(inputs)
    kernels.reset_launches()
    t0 = time.perf_counter()
    builder = CircuitBuilder()
    hook = builder_ops.get_bn254_hook(builder)
    hook.stark_config = StarkConfig(**H2G_HOOK_CONFIG)
    hook.timing = TimingTree(enabled=True)
    targets = [builder.add_virtual_target() for _ in inputs]
    out = h2g.hash_to_g2_circuit(builder, targets)
    for t in out.to_vec():
        builder.register_public_input(t)
    pw = Witness()
    for t, v in zip(targets, inputs):
        pw.set_target(t, v)
    circuit = builder.build()
    res = {"build_s": time.perf_counter() - t0, "targets": builder.num_targets}

    t0 = time.perf_counter()
    values = circuit.generate_witness(pw, device)
    torch.cuda.synchronize()
    res["witness_s"] = time.perf_counter() - t0
    res["witness_stages_s"] = {stage: secs for _, stage, secs in hook.timing.records}
    if out.get_witness(values) != want:
        raise AssertionError("h2g: the circuit's output differs from the native hash_to_g2")
    if not {"fq_exp", "g2_scalar_mul"} <= set(hook.proof):
        raise AssertionError(f"h2g: the hook proved {sorted(hook.proof)}")
    t0 = time.perf_counter()
    data = circuit.outer_data(TABLE_BITS, device)
    res["compile_outer_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    proof, publics = outer.prove_outer(data, values, TEST_CONFIG)
    torch.cuda.synchronize()
    res["outer_proof_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    circuit.verify_all(proof, publics, TEST_CONFIG, TABLE_BITS, device)
    res["verify_all_s"] = time.perf_counter() - t0
    res["launches"] = dict(kernels.LAUNCHES)
    res["calls"] = {k: dict(kernels.CALLS[k]) for k in kernels.KERNEL_IDS}
    words = [sum(v << (32 * i) for i, v in enumerate(publics[8 * k : 8 * k + 8]))
             for k in range(4)]
    if ((words[0], words[1]), (words[2], words[3])) != want:
        raise AssertionError("h2g: the public point differs from the native hash_to_g2")
    flipped = interop.proof_from_fields(interop.proof_to_fields(proof))
    flipped.openings.trace_zeta[0] = flipped.openings.trace_zeta[0] + GLExt(1)
    try:
        circuit.verify_all(flipped, publics, TEST_CONFIG, TABLE_BITS, device)
    except verify_mod.VerificationError as e:
        log(f"  flipped opening rejected: {e}")
    else:
        raise AssertionError("h2g: an outer proof with a flipped opening was accepted")
    missing = [k for k in kernels.KERNEL_IDS if res["launches"][k] <= 0]
    if missing:
        raise AssertionError(f"the h2g phase never launched {missing}")
    if res["calls"]["K2"].get((1,), 0):
        raise AssertionError(f"the h2g phase launched K2 at [1, 12] {res['calls']['K2'][(1,)]} times")
    log(f"  {H2G_INPUTS} inputs, {res['targets']:,} targets, build {res['build_s']:.2f} s; "
        f"witness {res['witness_s']:.2f} s ("
        + ", ".join(f"{k} {v:.2f} s" for k, v in res["witness_stages_s"].items())
        + f"); compile_outer {res['compile_outer_s']:.2f} s (2^{data.n_log} x "
        f"{data.lay.width}); outer proof {res['outer_proof_s']:.2f} s; verify_all "
        f"{res['verify_all_s']:.2f} s; launches {res['launches']}, K2 at [1, 12] 0, "
        f"K2t {res['launches']['K2t']}")
    log("  output = native hash_to_g2(inputs), public and in the witness")
    return res


def synced_proof(path) -> dict:
    """Stage times and wall of one proof under the synchronising timer."""
    from plonky2_bn254_tpu_torch.utils.timing import TimingTree

    torch.cuda.reset_peak_memory_stats(path.device)
    tt = TimingTree(enabled=True)
    t0 = time.perf_counter()
    path.prove(tt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = gb(torch.cuda.max_memory_allocated(path.device))
    log(f"# path {path.name}: stage times of a synchronised proof:")
    for depth, stage, secs in tt.records:
        log(f"  {'  ' * depth}{secs:8.3f}s  {stage}")
    rate = f" ({N_OPS / wall:.2f} ops/s)" if path.name in PATHS else ""
    log(f"  synchronised proof wall {wall:.3f} s{rate}; peak device memory {peak:.2f} GB")
    stages = {stage: secs for depth, stage, secs in tt.records if depth == 0}
    host = getattr(path, "host_fs_stages", None)
    if host:
        dev = {**{k: v for k, v in stages.items() if k != "trace gen"},
               "proof": wall - stages.get("trace gen", 0.0)}
        log("  synchronised stages, device FS / host FS (s): " + ", ".join(
            f"{k} {dev.get(k, 0):.3f} / {host.get(k, 0):.3f}" for k in dict.fromkeys([*dev, *host])))
    return {"synced_wall_s": wall, "synced_peak_gb": peak, "stages_s": stages}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()

    from plonky2_bn254_tpu_torch import kernels

    card = card_line()
    log(f"# card: {card}")
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    def phase_done(name: str, t0: float) -> None:
        log(f"# phase {name}: {time.perf_counter() - t0:.1f} s "
            f"(total {time.perf_counter() - t_start:.1f} s)")

    # ---- build ---------------------------------------------------------
    t0 = time.perf_counter()
    kernels.library()
    log(f"# build: {time.perf_counter() - t0:.2f} s -> {kernels.BUILD.path}")
    for line in kernels.BUILD.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  {line.strip()}")

    # ---- op costs, demo proof ----------------------------------------------
    from plonky2_bn254_tpu_torch import bounds

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clock_mhz = clock_max_mhz()
    costs, mul_opcodes = bounds.sass_costs(kernels.BUILD_DIR / "op_probe")
    log(f"# bound: {bounds.INT32_OPS_PER_CLK_PER_SM} int32 ops/clk/SM x {sms} SMs x "
        f"{clock_mhz:.0f} MHz (clocks.max.sm), {bounds.HBM_BYTES_PER_S / 1e12} TB/s")
    log(f"  SASS of csrc/goldilocks.cuh {costs}; gl::mul opcodes {mul_opcodes}")
    if costs != bounds.OP_COST:
        raise AssertionError(f"SASS op costs {costs} differ from bounds.OP_COST {bounds.OP_COST}")
    latency, latency_raw = bounds.op_latencies(kernels.BUILD_DIR / "op_probe")
    log(f"  latency in cycles (clock64 chains of csrc/op_probe.cu) "
        f"{ {k: round(v, 3) for k, v in latency_raw.items()} }; one permutation's critical path "
        f"{bounds.permutation_latency()} cycles = "
        f"{bounds.permutation_latency() / clock_mhz:.3f} us at {clock_mhz:.0f} MHz "
        f"({bounds.permutation_latency(8)} after a full-rate absorb)")
    if latency != bounds.OP_LATENCY:
        raise AssertionError(f"op latencies {latency} differ from bounds.OP_LATENCY "
                             f"{bounds.OP_LATENCY}")

    log("# native host Poseidon (plonky2_bn254_tpu_torch/csrc/host_poseidon.cpp)")
    native = native_check()
    log("# demo STARK: card proof vs CPU proof")
    demo_matches_cpu(device)
    log("  equal, and verified")
    phase_done("build, native library and demo", t_start)

    # ---- the three paths ---------------------------------------------------
    paths, runs = {}, {}
    for name in PATHS:
        t0 = time.perf_counter()
        paths[name] = Path(name, device)
        runs[name] = first_proof(paths[name])
        paths[name].host_fs_stages = runs[name]["host_fs_stages_s"]
        phase_done(f"{name} first proof", t0)
        if name == MESH_PATH:
            t0 = time.perf_counter()
            runs["mesh"] = mesh_phase(paths[name], runs[name], card)
            phase_done("mesh", t0)

    t0 = time.perf_counter()
    paths["compose"] = Compose(device)
    runs["compose"] = compose_first_proof(paths["compose"])
    phase_done("compose build, witness, compile_outer, first outer proof, verify_all", t0)
    main_paths = PATHS + ("compose",)

    log(f"# phase h2g: hash_to_g2_circuit over {H2G_INPUTS} inputs, real backend on the card")
    t0 = time.perf_counter()
    runs["h2g"] = hash_to_g2_phase(device)
    phase_done("h2g", t0)

    log("# kernels vs plain versions at every path shape (torch.equal, tolerance 0)")
    t0 = time.perf_counter()
    calls_by_path = {p: runs[p]["calls"] for p in main_paths + ("h2g", "mesh")}
    for p in PATHS:
        calls_by_path[f"{p} host FS"] = runs[p]["host_fs_calls"]
    calls_by_path["compose witness"] = runs["compose"]["witness_calls"]
    calls_by_path["compose compile_outer"] = runs["compose"]["compile_calls"]
    kres = compare_kernels(device, calls_by_path, sms, clock_mhz)
    phase_done("kernels", t0)

    # ---- synchronised proofs -------------------------------------------------
    for name in main_paths:
        t0 = time.perf_counter()
        runs[name].update(synced_proof(paths[name]))
        phase_done(f"{name} synchronised proof", t0)

    name = torch.cuda.get_device_name(0)
    hidden = ("calls", "witness_calls", "compile_calls", "host_fs_calls")
    print(json.dumps({"native_host_poseidon": native}))
    for p in main_paths + ("h2g", "mesh"):
        print(json.dumps({"path": p, **{k: v for k, v in runs[p].items() if k not in hidden}}))

    table = {"kernels": []}
    for kid in kernels.KERNEL_IDS:
        main = kres[kid].get("main") or kres[kid]["timed"][0]
        by_path = {p: runs[p]["launches"][kid] for p in main_paths + ("h2g", "mesh")}
        table["kernels"].append({
            "name": f"{kid} {KERNELS[kid][0]}", "route": "cuda", "source": KERNELS[kid][1],
            "replaces": KERNELS[kid][2], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": kres[kid]["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "share": main["share"], "key": main["key"],
            **({"us_per_perm": main["us_per_perm"],
                "permutation_latency_cycles": kres[kid]["permutation_latency_cycles"]}
               if kid == "K2t" else {}),
            "shapes": [{k: r[k] for k in ("key", "launches", "ms", "bound_ms", "share",
                                          "us_per_perm") if k in r}
                       for r in kres[kid]["timed"]],
        })
    log(f"# total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(table))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
