"""Device idle share of the outer proof's quotient, from one torch.profiler window.

    python3 scripts/torch_outer_profile.py

Builds the compose circuit of chip_smoke.py (two fq_exp ops at
DEFAULT_CONFIG, the 2^20-row outer trace) on the card, proves it once to
warm the process's one-time work (the outer stark's tape, the coset's
selector rows), then once more with `torch.profiler` recording the
quotient's evaluation: the K5 launch
(the outer stark's constraints at every point of the 2^21-point coset), the
iNTT and the degree split, without the quotient's commit.  Prints the
window's host wall, the device time its kernels took, the idle share (1 -
device / wall), the kernel count and K5's device time, then the proof's
stage times, and a JSON line with the same numbers.  Needs a CUDA card; run
from the repository root with PYTHONPATH set to it.
"""

import argparse
import json
import sys
import time

import torch


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
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
    path.prove()

    original = prove_mod._make_quotient
    state = {"prof": None, "wall": 0.0}

    def profiled_quotient(*a, **k):
        core = original(*a, **k)

        def run(*args):
            torch.cuda.synchronize()
            state["prof"] = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA])
            state["prof"].start()
            t0 = time.perf_counter()
            out = core(*args)
            torch.cuda.synchronize()
            state["wall"] = time.perf_counter() - t0
            state["prof"].stop()
            return out

        return run

    prove_mod._make_quotient = profiled_quotient
    tt = TimingTree(enabled=True)
    try:
        path.prove(tt)
    finally:
        prove_mod._make_quotient = original

    kernels = [e for e in state["prof"].events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    k5_s = sum(e.time_range.elapsed_us() for e in kernels if "quotient_tape" in e.name) / 1e6
    wall = state["wall"]
    print("# quotient evaluation (K5, iNTT, degree split):")
    print(f"  host wall {wall:.4f} s, device busy {busy_s:.4f} s, idle share "
          f"{1 - busy_s / wall:.4f}, {len(kernels)} kernels, K5 {k5_s * 1e3:.3f} ms")
    print("# stage times of the same proof (the quotient ran under the profiler):")
    tt.print()
    print(json.dumps({"quotient": {"wall_s": wall, "device_busy_s": busy_s,
                                   "idle_share": 1 - busy_s / wall, "kernels": len(kernels),
                                   "k5_s": k5_s},
                      "stages_s": tt.stages()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
