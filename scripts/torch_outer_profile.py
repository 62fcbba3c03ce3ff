"""Device idle share of the outer proof's quotient, from one torch.profiler slice.

    python3 scripts/torch_outer_profile.py [--start 8] [--chunks 4]

Builds the compose circuit of chip_smoke.py (two fq_exp ops at
DEFAULT_CONFIG, the 2^20-row outer trace) on the card, then proves it once
with `torch.profiler` recording a slice of the quotient: the constraint
evaluation of `--chunks` consecutive quotient chunks from chunk `--start`
(each chunk is `prover.prove.QUOTIENT_CHUNK` coset points).  Prints the
slice's host wall, the device time its kernels took, the idle share (1 -
device / wall) and the kernel count, then the proof's synchronised stage
times, and a JSON line with the same numbers.  Needs a CUDA card; run from
the repository root with PYTHONPATH set to it.
"""

import argparse
import json
import sys
import time

import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--start", type=int, default=8)
    ap.add_argument("--chunks", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_outer_profile: no CUDA device")
    device = torch.device("cuda", 0)

    from chip_smoke import Compose, card_line
    from plonky2_bn254_tpu_torch.prover import prove as prove_mod
    from plonky2_bn254_tpu_torch.utils.timing import TimingTree

    print(f"# card: {card_line()}", flush=True)
    path = Compose(device)
    path.witness()
    path.compile()

    original = prove_mod.cons.eval_all_constraints
    state = {"calls": 0, "prof": None, "t0": 0.0, "wall": 0.0}
    last = args.start + args.chunks - 1

    def profiled(*a, **k):
        i = state["calls"]
        state["calls"] += 1
        if i == args.start:
            torch.cuda.synchronize()
            state["prof"] = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA])
            state["prof"].start()
            state["t0"] = time.perf_counter()
        out = original(*a, **k)
        if i == last:
            torch.cuda.synchronize()
            state["wall"] = time.perf_counter() - state["t0"]
            state["prof"].stop()
        return out

    prove_mod.cons.eval_all_constraints = profiled
    tt = TimingTree(enabled=True)
    try:
        path.prove(tt)
    finally:
        prove_mod.cons.eval_all_constraints = original
    if state["calls"] <= last:
        raise SystemExit(f"the quotient has only {state['calls']} chunks")

    kernels = [e for e in state["prof"].events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    wall = state["wall"]
    print(f"# quotient slice: chunks {args.start}..{last} of {state['calls']} "
          f"({prove_mod.QUOTIENT_CHUNK} points each)")
    print(f"  host wall {wall:.4f} s, device busy {busy_s:.4f} s, idle share "
          f"{1 - busy_s / wall:.4f}, {len(kernels)} kernels ({len(kernels) / args.chunks:.0f} a chunk)")
    print("# stage times of the same proof (the slice ran under the profiler):")
    tt.print()
    print(json.dumps({"quotient_slice": {"chunks": args.chunks, "chunk_points": prove_mod.QUOTIENT_CHUNK,
                                         "n_chunks": state["calls"], "wall_s": wall,
                                         "device_busy_s": busy_s, "idle_share": 1 - busy_s / wall,
                                         "kernels": len(kernels)},
                      "stages_s": tt.stages()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
