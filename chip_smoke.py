"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. the card: name, power limit and maximum SM clock from nvidia-smi;
  2. build the CUDA kernels from plonky2_bn254_tpu_torch/csrc (nvcc, sm_90a,
     one nvcc a source, all started together), and count the SASS
     instructions of each Goldilocks operation (bounds.sass_costs): they must
     equal the fixed costs the bounds use;
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
     (every kernel launched; device FS also K2 at [1, 12]), its synchronised
     wall and its synchronising CUDA operations (torch.cuda sync debug
     mode) by site; the proofs equal field by field; the device-FS
     proof verifies and is rejected with one opening flipped; the wrappers
     record the shape of every launch (kernels.CALLS);
  6. the compose path, the circuit API's production product (as
     scripts/prove_compose_default.py and scripts/bench_outer.py define it):
     two fq_exp ops from numpy.random.default_rng(123) recorded on a
     CircuitBuilder, the first op's output limbs public, the hook and the
     outer proof at DEFAULT_CONFIG, table_bits 16:
       build          the in-circuit recursive FqExp verifier,
       witness        the inner FqExp batch proved on the card, self-verified
                      and injected (outputs checked against pow(x, s, P)),
       compile_outer  the 2^20-row universal-gate layout and its verifier key,
       outer proof    with the launch counts set to 0 just before it and read
                      just after: every kernel must have launched,
     then verify_all, a corrupted public value and a flipped opening both
     rejected;
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
     plain version at the largest and the smallest;
  9. per path, the stage times and wall of one proof under the
     synchronising timer and its peak device memory.

Prints each phase's seconds, a JSON line for the native library and per
path ("path": both flows' walls, synchronising operations and launches,
verify, synchronised wall, peak memory), the kernel table as one JSON line
(each kernel's largest shape, and every shape with its launches on each
path under "shapes"), then the card line, then
{"ok": true, "device": {...}} as the last line.
"""

import json
import os
import subprocess
import sys
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

KERNELS = {
    "K1": ("hash_leaves", "plonky2_bn254_tpu_torch/csrc/poseidon.cu",
           "plonky2_bn254_tpu/field/poseidon_pallas.py:385"),
    "K2": ("permute_states", "plonky2_bn254_tpu_torch/csrc/poseidon.cu",
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


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` runs, after one warm-up run."""
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
    "K3": [(5, 8, 8, True), (13, 1 << 12, 1 << 12, True), (3, 1 << 20, 1 << 20, True),
           (1, 1, 1, True), (7, 1 << 17, 1 << 17, False)],
    "K4": [(5, 8, 16, False), (1, 1, 2, False), (7, 1 << 12, 1 << 14, False),
           (3, 1 << 16, 1 << 18, False)],
}


def compare_kernels(device, calls_by_path: dict, sms: int, clock_mhz: float) -> dict:
    """Each kernel vs its plain version on the card at every key any path
    launched it with (timed, beside the bound of bounds.py) and at
    ODD_KEYS.  Raises on the first disagreement."""
    from plonky2_bn254_tpu_torch import bounds

    rng = np.random.default_rng(SEED)
    results = {}
    for kid, odd in ODD_KEYS.items():
        calls = Counter()
        for per_path in calls_by_path.values():
            calls.update(per_path[kid])
        timed = sorted(calls, key=lambda k: kernel_call(kid, k)[2], reverse=True)
        err, rows = 0, []
        for i, key in enumerate(timed + [k for k in odd if k not in calls]):
            kern, plain, work, shape = kernel_call(kid, key)
            x = rand_residues(rng, shape, device)
            got = kern(x)
            want = plain(x)
            torch.cuda.synchronize()
            err = max(err, max_abs_err(got, want))
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                raise AssertionError(f"{kid} {key}: {bad} elements differ from the plain version")
            del got, want
            if i < len(timed):
                ms = cuda_ms(lambda: kern(x), reps=20)
                plain_ms = (cuda_ms(lambda: plain(x), reps=1)
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
    launches; fails unless every kernel launched (and, for device FS, K2 at
    [1, 12], the device challenger's duplex)."""
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
        f"{k2_single}; peak device memory {peak:.2f} GB")
    missing = [k for k in kernels.KERNEL_IDS if launches[k] <= 0]
    if device_fs and k2_single <= 0:
        missing.append("K2 at [1, 12]")
    if missing:
        raise AssertionError(f"path {path.name} ({flow}) never launched {missing}")
    return proof, {"wall_s": wall, "syncs": sum(sites.values()), "sync_sites": dict(sites),
                   "launches": launches, "k2_single_launches": k2_single, "peak_gb": peak,
                   "calls": calls}


def first_proof(path: Path) -> dict:
    """Trace the path's inputs once; prove the trace with the transcript on
    the device (the default on the card), on the host and on the device
    again; the proofs equal field by field; the device-FS proof verifies,
    and is rejected with one opening flipped."""
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
    return {"trace_gen_s": trace_s, "verify_s": verify_s,
            "device_fs": {k: v for k, v in dev_run.items() if k != "calls"},
            "host_fs": {k: v for k, v in host_run.items() if k != "calls"},
            "device_fs_again": {k: v for k, v in warm_run.items() if k != "calls"},
            "launches": dev_run["launches"], "calls": dev_run["calls"],
            "host_fs_calls": host_run["calls"]}


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
        log(f"  witness {witness_s:.2f} s (inner FqExp proof on the card + self-verify + "
            f"fixpoint); " + ", ".join(f"{k} {v:.2f} s" for k, v in stages.items()))
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

    def verify(self, proof, publics):
        from plonky2_bn254_tpu_torch.prover.config import DEFAULT_CONFIG

        self.circuit.verify_all(proof, publics, DEFAULT_CONFIG, TABLE_BITS, self.device)


def compose_first_proof(path: Compose) -> dict:
    """build -> witness -> compile_outer -> the first outer proof (launch
    counts set to 0 just before it and read just after) -> verify_all, and
    a corrupted public value and a flipped opening rejected."""
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
    log(f"  first outer proof {prove_s:.2f} s; launches {launches}; peak device memory "
        f"{peak:.2f} GB")
    missing = [k for k in kernels.KERNEL_IDS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"path compose never launched {missing} on the outer proof")

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
    res.update({"first_proof_s": prove_s, "verify_s": verify_s, "first_peak_gb": peak,
                "launches": launches, "calls": calls})
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
    log(f"  {H2G_INPUTS} inputs, {res['targets']:,} targets, build {res['build_s']:.2f} s; "
        f"witness {res['witness_s']:.2f} s ("
        + ", ".join(f"{k} {v:.2f} s" for k, v in res["witness_stages_s"].items())
        + f"); compile_outer {res['compile_outer_s']:.2f} s (2^{data.n_log} x "
        f"{data.lay.width}); outer proof {res['outer_proof_s']:.2f} s; verify_all "
        f"{res['verify_all_s']:.2f} s; launches {res['launches']}")
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
    return {"synced_wall_s": wall, "synced_peak_gb": peak,
            "stages_s": {stage: secs for depth, stage, secs in tt.records if depth == 0}}


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
        phase_done(f"{name} first proof", t0)

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
    calls_by_path = {p: runs[p]["calls"] for p in main_paths + ("h2g",)}
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
    for p in main_paths + ("h2g",):
        print(json.dumps({"path": p, **{k: v for k, v in runs[p].items() if k not in hidden}}))

    table = {"kernels": []}
    for kid in kernels.KERNEL_IDS:
        main = kres[kid]["timed"][0]
        by_path = {p: runs[p]["launches"][kid] for p in main_paths + ("h2g",)}
        table["kernels"].append({
            "name": f"{kid} {KERNELS[kid][0]}", "route": "cuda", "source": KERNELS[kid][1],
            "replaces": KERNELS[kid][2], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": kres[kid]["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "share": main["share"], "key": main["key"],
            "shapes": [{k: r[k] for k in ("key", "launches", "ms", "bound_ms", "share")}
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
