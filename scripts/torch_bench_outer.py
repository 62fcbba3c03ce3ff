"""Benchmark of the port's composed product: the outer proof at DEFAULT_CONFIG on one card.

    python3 scripts/torch_bench_outer.py [--out PATH]

The port's counterpart of scripts/bench_outer.py, on the product that
chip_smoke.py's compose path proves (its `Compose`, so the smoke and the
bench prove one product): two fq_exp ops from numpy.random.default_rng(123)
(s = r1 << 150 | r0) on a CircuitBuilder, the first output's limbs public,
the BN254 hook and the outer proof at DEFAULT_CONFIG, table_bits 16 (a
2^20 x 108 outer trace).  Stages, each on the host clock around work that
ends in torch.cuda.synchronize():
  build          record the ops and build the circuit (the in-circuit
                 recursive FqExp verifier);
  witness        generate_witness: the inner FqExp batch proved on the card,
                 self-verified and injected; outputs equal pow(x, s, P);
  compile_outer  the universal-gate layout and its verifier key;
  outer proof    the first (cold tables), then BENCH_REPEATS (default 5)
                 more, closed loop, with their median, quartiles and walls;
  verify_all     of the last proof; the public statement equals pow(x, s, P)
                 and a corrupted public value is rejected.

Prints ONE JSON line on stdout: bench_outer.py's keys (metric
"composed_outer_prove_steady_s", here the median of the repeated walls,
value, unit, stages) plus walls_s, median_s, q1_s, q3_s, n, peak_gb (over
the outer proofs), build_s (the kernel build, apart from every stage),
verified and device.  Progress goes to stderr.  Writes a file only where
--out names one.  Without a CUDA card it exits non-zero and prints nothing
on stdout.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

METRIC = "composed_outer_prove_steady_s"


def timed_proof(path):
    """(proof, synchronised wall) of one outer proof of `path`."""
    t0 = time.perf_counter()
    proof = path.prove()
    torch.cuda.synchronize(path.device)
    return proof, time.perf_counter() - t0


def check_publics(path, proof) -> None:
    """The public statement equals pow(x, s, P) of the first op, and the
    proof with a corrupted public value is rejected."""
    from plonky2_bn254_tpu_torch.field import goldilocks as gl
    from plonky2_bn254_tpu_torch.prover.verify import VerificationError

    statement = sum(v << (32 * i) for i, v in enumerate(path.publics))
    if statement != path.outs[0][1]:
        raise AssertionError("the public statement differs from pow(x, s, P)")
    bad = list(path.publics)
    bad[0] = (bad[0] + 1) % gl.P
    try:
        path.verify(proof, bad)
    except VerificationError:
        return
    raise AssertionError("a proof with a corrupted public value was accepted")


def run(device, repeats: int, mark) -> dict:
    """The composed product's stages on `device` (module docstring);
    `mark(message)` narrates each step as it ends.  Returns the result line
    as a dict; raises on any failed check."""
    from bench_torch import build_kernels, device_record, wall_stats
    from chip_smoke import Compose

    kernel_build_s = build_kernels(device)
    mark(f"kernels built in {kernel_build_s:.2f} s")
    path = Compose(device)
    mark(f"build done: {path.circuit.builder.num_targets:,} targets in {path.build_s:.2f} s")
    witness = path.witness()
    mark(f"witness generated (inner STARK proven, self-verified, injected): "
         f"{witness['witness_s']:.2f} s; outputs equal pow(x, s, P)")
    compiled = path.compile()
    mark(f"compile_outer: {compiled['compile_outer_s']:.2f} s (2^{compiled['outer_rows_log2']} rows)")
    torch.cuda.reset_peak_memory_stats(device)
    proof, cold_s = timed_proof(path)
    mark(f"outer proof at DEFAULT_CONFIG: {cold_s:.2f} s (the first)")
    walls = []
    for i in range(repeats):
        proof, wall = timed_proof(path)
        walls.append(wall)
        mark(f"outer proof {i + 1} of {repeats}: {wall:.2f} s")
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    t0 = time.perf_counter()
    path.verify(proof, path.publics)
    verify_s = time.perf_counter() - t0
    mark(f"verify_all: {verify_s:.2f} s -- composed artifact verified")
    check_publics(path, proof)
    mark("corrupted public input rejected")
    stats = wall_stats(walls)
    stages = {"build_s": path.build_s, "witness_inner_stark_s": witness["witness_s"],
              "witness_stages_s": witness["witness_stages_s"],
              "compile_outer_s": compiled["compile_outer_s"],
              "outer_rows_log2": compiled["outer_rows_log2"], "outer_prove_cold_s": cold_s,
              "outer_prove_steady_s": stats["median_s"], "verify_all_s": verify_s,
              "corrupted_public_rejected": True}
    return {"metric": METRIC, "value": stats["median_s"], "unit": "s", "stages": stages,
            **stats, "peak_gb": peak_gb, "build_s": kernel_build_s, "verified": True,
            "device": device_record(device)}


def main() -> int:
    from chip_smoke import require_card

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the result line to this file")
    args = ap.parse_args()
    device = require_card("torch_bench_outer")
    repeats = int(os.environ.get("BENCH_REPEATS", "5"))
    t_start = time.perf_counter()

    def mark(msg: str) -> None:
        print(f"[{time.perf_counter() - t_start:7.1f}s] {msg}", file=sys.stderr, flush=True)

    with contextlib.redirect_stdout(sys.stderr):  # Compose narrates on stdout
        result = run(device, repeats, mark)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
