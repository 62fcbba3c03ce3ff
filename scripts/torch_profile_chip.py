"""Where a machine proof's device time goes on one card: a step-by-step
microprofile of the G1 hot path, and torch.profiler slices of three prover
stages.

    python3 scripts/torch_profile_chip.py

The port's counterpart of scripts/profile_chip.py.  Two parts:

(a) The G1 hot path of bench_torch.py (128 ops, DEFAULT_CONFIG) step by
    step, each step on the host clock around work that ends in
    torch.cuda.synchronize(), over REPS + 1 distinct input sets (seeds
    2024 + i, as profile_chip.py draws them; the first call of each step
    warms it and is discarded): trace generation, the transpose to columns,
    the iNTT (K3) and its plain PyTorch version, the LDE (K4) and its plain
    version, the bit-reversed leaf gather, the Merkle tree levels (K1 on
    the leaves and on every two-to-one level), aux (fixed challenges), the
    aux commit's iNTT, LDE and tree, and the quotient.  Prints each step's
    best and median seconds, and the round trip of one synchronising read
    of a device value.

(b) Three proofs of one trace of each machine (g1, fq_exp, g2; 128 ops,
    DEFAULT_CONFIG, device Fiat–Shamir): a warm-up, one under the
    TimingTree, and one with torch.profiler recording only the
    aux, openings and FRI-oracle stages (a whole proof under the profiler
    runs past 900 s, trace generation alone launching millions of
    kernels).  For each slice: its synchronised wall in the timed proof (no
    profiler) and under the profiler, the device busy time (the kernels
    and copies the profiler saw), the idle share 1 - busy / wall against
    each wall, the kernel count and the top kernels by device time.

Ends with one JSON line holding both parts.  Needs a CUDA card: without one
it exits non-zero.
"""

from __future__ import annotations

import json
import sys
import time
from collections import Counter
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_torch import sync  # noqa: E402
from plonky2_bn254_tpu_torch.utils.timing import TimingTree  # noqa: E402

REPS = 3
N_OPS = 128
SLICES = ("aux", "openings", "fri oracle")
TOP_KERNELS = 5


def timed(fn, inputs, device) -> tuple:
    """(best s, median s, outputs) of `fn` over `inputs`, each call
    synchronised; the first call warms `fn` and is not counted."""
    outs, walls = [], []
    for i, x in enumerate(inputs):
        sync(device)
        t0 = time.perf_counter()
        outs.append(fn(x))
        sync(device)
        if i:
            walls.append(time.perf_counter() - t0)
    return min(walls), float(np.median(walls)), outs


def sync_round_trip_ms(device, reps: int = 10) -> float:
    """Mean milliseconds of one synchronising read of a device value."""
    tiny = torch.ones(8, dtype=torch.int64, device=device)
    int(tiny[0])
    t0 = time.perf_counter()
    for _ in range(reps):
        int(tiny[0])
    return (time.perf_counter() - t0) / reps * 1e3


def fixed_challenges(stark, device) -> dict:
    """profile_chip.py's fixed challenges: betas (3, 5), gammas (7, 11),
    alphas (13, 17), every CTL total 1; the CTL weight specs for the betas."""
    from plonky2_bn254_tpu_torch.field import goldilocks as gl
    from plonky2_bn254_tpu_torch.interop import tensor_from_u64

    def vec(values):
        return tensor_from_u64(np.array(values, dtype=np.uint64), device)

    specs = [[(torch.tensor([c for c, _ in ctl.flat_weights(b, gl.P)], dtype=torch.int64,
                            device=device),
               vec([w for _, w in ctl.flat_weights(b, gl.P)])) for ctl in stark.ctls]
             for b in (3, 5)]
    return {"betas": [3, 5], "gammas": [7, 11], "specs": specs, "alphas": [13, 17],
            "totals": [[1] * len(stark.ctls)] * 2}


def hot_path(machine: str, n_ops: int, config, reps: int, device, report) -> None:
    """Part (a) for `machine`: `report(step, best_s, median_s)` for each
    step, over reps + 1 input sets."""
    from bench_torch import load_machine
    from plonky2_bn254_tpu_torch.field import ntt_cuda
    from plonky2_bn254_tpu_torch.prover import prove as prove_mod
    from plonky2_bn254_tpu_torch.prover.merkle import device_tree_levels
    from plonky2_bn254_tpu_torch.prover.poly_batch import leaf_rows

    rate = config.rate_bits

    def step(name, fn, inputs):
        best, median, outs = timed(fn, inputs, device)
        report(name, best, median)
        return outs

    loaded = [load_machine(machine, n_ops, device, seed=2024 + i) for i in range(reps + 1)]
    stark = loaded[0][0]
    traces = step("trace gen", lambda make_trace: make_trace(), [m[2] for m in loaded])
    n, w = traces[0].shape
    n_log = n.bit_length() - 1
    cols = step(f"transpose [{n}, {w}] -> [{w}, {n}]", lambda x: x.T.contiguous(), traces)
    del traces
    coeffs = step(f"iNTT (K3) [{w}, 2^{n_log}]", ntt_cuda.intt, cols)
    step(f"iNTT plain [{w}, 2^{n_log}]", ntt_cuda.intt_plain, cols)
    ldes = step(f"LDE (K4) [{w}, 2^{n_log}] -> 2^{n_log + rate}",
                lambda c: ntt_cuda.coset_lde(c, rate), coeffs)
    step(f"LDE plain [{w}, 2^{n_log}] -> 2^{n_log + rate}",
         lambda c: ntt_cuda.coset_lde_plain(c, rate), coeffs)
    del coeffs
    leaves = step(f"leaf gather + T [2^{n_log + rate}, {w}]", leaf_rows, ldes)
    tree = lambda lv: device_tree_levels(lv, config.cap_height)  # noqa: E731
    step("tree levels (K1: leaves, two-to-one levels)", tree, leaves)
    del leaves

    ch = fixed_challenges(stark, device)
    aux_core = prove_mod._make_aux(stark)
    aux_cols = step("aux", lambda c: aux_core(c, ch["betas"], ch["gammas"], ch["specs"]), cols)
    del cols
    k = aux_cols[0].shape[0]
    a_coeffs = step(f"aux commit iNTT (K3) [{k}, 2^{n_log}]", ntt_cuda.intt, aux_cols)
    del aux_cols
    a_ldes = step(f"aux commit LDE (K4) [{k}, 2^{n_log}]",
                  lambda c: ntt_cuda.coset_lde(c, rate), a_coeffs)
    del a_coeffs
    step("aux commit tree (leaf gather + K1)", lambda a: tree(leaf_rows(a)), a_ldes)

    quotient = prove_mod._make_quotient(stark, n_log, config)
    weights = [[wt for _, wt in per] for per in ch["specs"]]
    challenges = list(zip(ch["betas"], ch["gammas"]))
    how = ("K5, one launch" if torch.device(device).type == "cuda"
           else f"eager, {prove_mod.QUOTIENT_CHUNK}-point chunks")
    step(f"quotient ({how}; iNTT, degree split)",
         lambda pair: quotient(pair[0], pair[1], ch["alphas"], challenges, ch["totals"], weights),
         list(zip(ldes, a_ldes)))


class SliceProfiler(TimingTree):
    """A synchronising TimingTree that runs torch.profiler over each scope
    named in `slices` and keeps, per slice, the wall and what the profiler
    saw on the device."""

    def __init__(self, slices, device):
        super().__init__(enabled=True)
        self.slices = tuple(slices)
        self.device = torch.device(device)
        self.results = {}

    @contextmanager
    def scope(self, name: str):
        if name not in self.slices:
            with super().scope(name):
                yield
            return
        # the host has no device time to record: no profiler there
        prof = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
                if self.device.type == "cuda" else None)
        sync(self.device)
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        try:
            with super().scope(name):
                yield
        finally:
            sync(self.device)
            wall = time.perf_counter() - t0
            if prof is not None:
                prof.stop()
            self.results[name] = device_summary(prof, wall)


def device_summary(prof, wall: float) -> dict:
    """Device busy seconds, idle share against `wall`, kernel count and the
    top kernels by device time, from a stopped profiler (None: nothing ran
    on a device)."""
    events = prof.events() if prof is not None else []
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name, count = Counter(), Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e6
        count[e.name] += 1
    busy = sum(by_name.values())
    return {"wall_s": wall, "device_busy_s": busy, "idle_share": 1 - busy / wall,
            "kernels": len(kernels),
            "top": [{"name": k, "s": s, "launches": count[k]}
                    for k, s in by_name.most_common(TOP_KERNELS)]}


def slice_profile(machine: str, n_ops: int, config, device) -> dict:
    """Part (b) for `machine`: per slice its `device_summary` under the
    profiler, with the same scope's wall in an unprofiled synchronised
    proof of the same trace after the warm-up (not the warm-up's, which
    holds first-call costs) and the idle share against it."""
    from bench_torch import load_machine
    from plonky2_bn254_tpu_torch.prover import prove as prove_mod

    stark, ctl_values, make_trace = load_machine(machine, n_ops, device)
    trace = make_trace()
    prove_mod.prove(stark, trace, ctl_values, config)  # warm-up
    steady = TimingTree(enabled=True)
    prove_mod.prove(stark, trace, ctl_values, config, timing=steady)
    prof = SliceProfiler(SLICES, device)
    prove_mod.prove(stark, trace, ctl_values, config, timing=prof)
    out = {}
    for name in SLICES:
        rec = prof.results[name]
        plain_wall = steady.total(name)
        out[name] = {**rec, "wall_unprofiled_s": plain_wall,
                     "idle_share_unprofiled": 1 - rec["device_busy_s"] / plain_wall}
    return out


def main() -> int:
    from bench_torch import build_kernels, device_record
    from chip_smoke import require_card
    from plonky2_bn254_tpu_torch.prover.config import DEFAULT_CONFIG

    device = require_card("torch_profile_chip")
    record = device_record(device)
    print(f"# card: {record['name']}, {record['power_limit']}", flush=True)
    print(f"# kernel build {build_kernels(device):.2f} s", flush=True)
    rtt = sync_round_trip_ms(device)
    print(f"sync round trip (one device value read): {rtt:.4f} ms", flush=True)

    print(f"# (a) G1 hot path, {N_OPS} ops, DEFAULT_CONFIG: best / median of {REPS} "
          "distinct inputs (s)", flush=True)
    steps = []

    def report(name, best, median):
        steps.append({"step": name, "best_s": best, "median_s": median})
        print(f"  {name:<48} {best:9.4f} {median:9.4f}", flush=True)

    hot_path("g1", N_OPS, DEFAULT_CONFIG, REPS, device, report)
    torch.cuda.empty_cache()

    print(f"# (b) torch.profiler slices, one proof a machine after a warm-up and a timed "
          f"proof, {N_OPS} ops, DEFAULT_CONFIG, device FS", flush=True)
    slices = {}
    for machine in ("g1", "fq_exp", "g2"):
        slices[machine] = slice_profile(machine, N_OPS, DEFAULT_CONFIG, device)
        torch.cuda.empty_cache()
        for name, rec in slices[machine].items():
            print(f"  {machine:<6} {name:<10}: wall {rec['wall_unprofiled_s']:.4f} s "
                  f"({rec['wall_s']:.4f} s profiled), device busy {rec['device_busy_s']:.4f} s, "
                  f"idle share {rec['idle_share_unprofiled']:.4f} "
                  f"({rec['idle_share']:.4f} profiled), {rec['kernels']} kernels", flush=True)
            for top in rec["top"]:
                print(f"      {top['s']:.5f} s x{top['launches']:<6} {top['name'][:90]}",
                      flush=True)
    print(json.dumps({"device": record, "sync_round_trip_ms": rtt, "hot_path": steps,
                      "slices": slices}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
