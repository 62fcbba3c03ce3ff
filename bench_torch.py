"""Benchmark of the PyTorch/CUDA port: G1 scalar-mul STARK proving throughput on one card.

    python3 bench_torch.py

The port's counterpart of bench.py, with bench.py's workload: BENCH_OPS
(default 128) G1 scalar multiplications s x + offset drawn from
numpy.random.default_rng(2024) exactly as bench.py draws them (the scalar,
then two random_g1 points, then the index t), one 2^16 x 781 trace: the
batch of chip_smoke.py's g1 path, through its `Path`.  Each
proof is trace generation plus `prove` at DEFAULT_CONFIG on the card, with
the Fiat–Shamir transcript on the device (the default there).

The loop is closed, one proof at a time:
  1. the kernel build (nvcc, and g++ for the host Poseidon), reported as
     build_s and kept out of every wall;
  2. one warm-up proof (cold tables), reported as warmup_s;
  3. the correctness gate: that proof verifies, and the same proof with one
     opening flipped is rejected;
  4. one proof under the TimingTree, for stages_s;
  5. BENCH_REPEATS (default 5) proofs without the timer, each wall on the
     host clock around work that ends in torch.cuda.synchronize().
The proofs of steps 4 and 5 must equal the gated proof field by field
(compared outside the walls): a proof that differs ends the run.

`value` is BENCH_OPS over the median of the step-5 walls.  bench.py takes
the smaller of its timed and untimed proof instead; the port's walls
spread with the host (G1 proofs of 27-52 s on the same device work), so
the median and the quartiles of several are reported.  `vs_baseline` keeps
bench.py's key and its denominator of 100 proofs/s, which was set for a
TPU pod and is not a goal.

Prints ONE JSON line on stdout: bench.py's keys (metric, value, unit,
vs_baseline, stages_s), plus walls_s, median_s, q1_s, q3_s, n, warmup_s,
build_s, peak_gb (max_memory_allocated over the step-5 proofs), verified
and device (name, power limit and count from nvidia-smi; SM clock and power
draw sampled before and after step 5).  Progress goes to stderr.

BENCH_DEADLINE_S (default 1700, as bench.py): a watchdog thread emits the
best result completed so far with "degraded": true if the run is still
going at the deadline, so a caller's timeout never meets an empty stdout.
Exactly one line is ever emitted.  Without a CUDA card the script exits
non-zero and prints nothing on stdout.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

import numpy as np
import torch

from chip_smoke import SEED, Path, card_line, require_card

METRIC = "g1_scalar_mul_proofs_per_s"
BASELINE_PROOFS_PER_S = 100.0


def load_machine(machine: str, n_ops: int, device, seed: int = SEED) -> tuple:
    """(stark, CTL values, make_trace) for `n_ops` ops of `machine` on
    `device`, `make_trace()` tracing them: "g1", "fq_exp" or "g2" is
    chip_smoke.Path's machine (bench.py's inputs from `seed`, 2^16-row
    traces at 128 ops); "demo" the 256-row demo STARK (starks/demo.py),
    one trace a proof (n_ops 1), for the CPU: the machines' proofs verify
    only at 2^16 rows and more (their range counters), which a CPU cannot
    prove quickly."""
    if machine != "demo":
        path = Path(machine, device, n_ops, seed)
        return path.stark, path.ctl_values, path.trace
    from plonky2_bn254_tpu_torch.starks.demo import demo_stark, demo_trace

    if n_ops != 1:
        raise ValueError("the demo machine proves one trace (n_ops 1)")
    trace, ctl_values = demo_trace(np.random.default_rng(seed))
    return demo_stark(), ctl_values, lambda: trace.to(device)


def quartiles(values) -> tuple:
    """(q1, median, q3) of `values`, linear interpolation between order
    statistics (numpy's default percentile)."""
    q1, med, q3 = np.percentile(np.asarray(values, dtype=np.float64), [25, 50, 75])
    return float(q1), float(med), float(q3)


def wall_stats(walls) -> dict:
    q1, med, q3 = quartiles(walls)
    return {"walls_s": list(walls), "median_s": med, "q1_s": q1, "q3_s": q3, "n": len(walls)}


def card_sample() -> dict:
    """The card's SM clock and power draw now (nvidia-smi)."""
    clock, draw = (part.strip() for part in card_line("clocks.sm,power.draw").split(","))
    return {"sm_clock": clock, "power_draw": draw}


def device_record(device) -> dict:
    """The device a result ran on: on a card its name and power limit as
    nvidia-smi gives them and the card count; on the host "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"platform": "cpu", "count": 1}
    name, limit = (part.strip() for part in card_line().split(","))
    return {"platform": "gpu", "name": name, "power_limit": limit,
            "kind": torch.cuda.get_device_name(device), "count": torch.cuda.device_count()}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build_kernels(device) -> float:
    """Seconds to build (or load) the host Poseidon library and, on a card,
    the CUDA kernel library."""
    from plonky2_bn254_tpu_torch import kernels
    from plonky2_bn254_tpu_torch.field import native

    t0 = time.perf_counter()
    native.library()
    if torch.device(device).type == "cuda":
        kernels.library()
    return time.perf_counter() - t0


def gate(stark, proof, ctl_values, config) -> None:
    """The correctness gate: `proof` verifies (raises VerificationError if
    not), and a copy with its first trace opening flipped is rejected
    (raises AssertionError if accepted)."""
    from plonky2_bn254_tpu_torch.field.extension import GLExt
    from plonky2_bn254_tpu_torch.interop import proof_from_fields, proof_to_fields
    from plonky2_bn254_tpu_torch.prover import verify as verify_mod

    verify_mod.verify(stark, proof, ctl_values, config)
    flipped = proof_from_fields(proof_to_fields(proof))
    flipped.openings.trace_zeta[0] = flipped.openings.trace_zeta[0] + GLExt(1)
    try:
        verify_mod.verify(stark, flipped, ctl_values, config)
    except verify_mod.VerificationError:
        return
    raise AssertionError("the gate accepted a proof with a flipped opening")


def proof_key(proof) -> str:
    """The proof's fields as one string: two proofs are equal if their keys are."""
    from plonky2_bn254_tpu_torch.interop import proof_to_fields

    return json.dumps(proof_to_fields(proof), default=lambda v: v.tolist())


def measure(machine: str, n_ops: int, config, repeats: int, device, progress=None) -> dict:
    """The bench on `device` (module docstring, steps 1-5) for `n_ops` ops of
    `machine` at `config` (`load_machine`); returns the result line as a
    dict.  Every proof after the gate must equal the gated proof field by
    field (the work is deterministic), else AssertionError.
    `progress(phase, partial)` is called as each step starts, with the best
    result so far (None before the warm-up ends)."""
    from plonky2_bn254_tpu_torch.prover import prove as prove_mod
    from plonky2_bn254_tpu_torch.utils.timing import TimingTree

    if repeats < 1:
        raise ValueError("measure needs at least one repeat")
    progress = progress or (lambda phase, partial: None)
    device = torch.device(device)
    stark, ctl_values, make_trace = load_machine(machine, n_ops, device)

    def one_proof(tt=None):
        tt = tt or TimingTree(enabled=False)
        with tt.scope("trace gen"):
            trace = make_trace()
        proof = prove_mod.prove(stark, trace, ctl_values, config, timing=tt)
        sync(device)
        return proof

    def check(proof, what: str) -> None:
        if proof_key(proof) != gated:
            raise AssertionError(f"{what} differs from the gated proof")

    def line(wall: float) -> dict:
        value = n_ops / wall
        return {"metric": METRIC if machine == "g1" else f"{machine}_proofs_per_s",
                "value": value, "unit": "proofs/s",
                "vs_baseline": value / BASELINE_PROOFS_PER_S}

    progress("build", None)
    build_s = build_kernels(device)
    log(f"# build (host Poseidon, CUDA kernels): {build_s:.3f} s")

    progress("warm-up proof", None)
    t0 = time.perf_counter()
    proof = one_proof()
    warmup_s = time.perf_counter() - t0
    log(f"# warm-up proof: {warmup_s:.3f} s")
    result = {**line(warmup_s), "verified": False, "warmup_s": warmup_s, "build_s": build_s}

    progress("gate", result)
    gate(stark, proof, ctl_values, config)
    gated = proof_key(proof)
    result["verified"] = True
    log("# gate: the proof verified; with one opening flipped it was rejected")

    progress("timed proof", result)
    tt = TimingTree(enabled=True)
    t0 = time.perf_counter()
    proof = one_proof(tt)
    log(f"# proof under the span timer (TimingTree): {time.perf_counter() - t0:.3f} s")
    check(proof, "the proof under the timer")
    tt.print(out=sys.stderr)
    stages = {}
    for _, name, secs in tt.records:
        stages[name] = stages.get(name, 0.0) + secs

    before = card_sample() if device.type == "cuda" else None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    walls = []
    for i in range(repeats):
        progress(f"proof {i + 1} of {repeats}", result)
        t0 = time.perf_counter()
        proof = one_proof()
        walls.append(time.perf_counter() - t0)
        log(f"# proof {i + 1} of {repeats}: {walls[-1]:.3f} s")
        check(proof, f"proof {i + 1} of {repeats}")
        stats = wall_stats(walls)
        result.update(line(stats["median_s"]), **stats)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else None
    after = card_sample() if device.type == "cuda" else None
    return {**result, "stages_s": stages, "peak_gb": peak_gb,
            "device": {**device_record(device), "before": before, "after": after}}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Emitter:
    """The one result line: written once, by the main thread or by the
    watchdog thread at the deadline, whichever comes first."""

    def __init__(self):
        self.lock = threading.Lock()
        self.emitted = False
        self.best = None  # the best result so far (a dict)
        self.phase = "start-up"

    def progress(self, phase: str, partial) -> None:
        self.phase = phase
        if partial is not None:
            self.best = dict(partial)

    def emit(self, obj: dict) -> bool:
        with self.lock:
            if self.emitted:
                return False
            self.emitted = True
            sys.stdout.write(json.dumps(obj) + "\n")
            sys.stdout.flush()
            return True

    def watchdog(self, deadline_s: float) -> None:
        """At the deadline: emit the best result so far, marked degraded,
        and end the process (0 if that result had passed the gate, else
        3)."""
        time.sleep(deadline_s)
        note = (f"watchdog: deadline {deadline_s:.0f} s hit in phase '{self.phase}'; "
                "the value is the best measurement completed so far")
        best = self.best or {"metric": METRIC, "value": 0.0, "unit": "proofs/s",
                             "vs_baseline": 0.0, "verified": False}
        if self.emit({**best, "degraded": True, "note": note}):
            os._exit(0 if best.get("verified") else 3)


def main() -> int:
    device = require_card("bench_torch")
    from plonky2_bn254_tpu_torch.prover.config import DEFAULT_CONFIG

    n_ops = int(os.environ.get("BENCH_OPS", "128"))
    repeats = int(os.environ.get("BENCH_REPEATS", "5"))
    deadline = float(os.environ.get("BENCH_DEADLINE_S", "1700"))
    emitter = Emitter()
    threading.Thread(target=emitter.watchdog, args=(deadline,), daemon=True).start()
    result = measure("g1", n_ops, DEFAULT_CONFIG, repeats, device, emitter.progress)
    emitter.emit(result)
    # the watchdog must not fire after the real result is out
    os._exit(0)


if __name__ == "__main__":
    sys.exit(main())
