"""Mesh scaling table of the port: the production FqExp trace (2^16 rows x
427 columns, one op from default_rng(17), as scripts/mesh_scaling.py)
proved at TEST_CONFIG on one device and by `prove(..., mesh=...)` on D
ranks of a gloo group, the rows split over them.

    python3 scripts/torch_mesh_scaling.py                 # the card: D = 1, 2, 4
    python3 scripts/torch_mesh_scaling.py --device cpu    # the host: D = 1, 2, 4, 8

On the card each D proves twice (the first meets cold tables), on the host
once (a CPU proof of this trace takes minutes); the table shows the last
proof's wall (barrier to barrier on a mesh), each rank's peak
(device memory on the card, resident set on the host) and the bytes each
rank sent.  The single-device proof verifies; every rank's proof must
equal it field by field, or the script raises.  On one card the ranks
share it through gloo (every exchange crosses the host): the walls are no
model of a multi-card mesh.
"""

import argparse
import json
import sys
import tempfile
import time

import torch

from torch_mesh_common import as_json, check_same, fq_exp_inputs, fq_exp_trace, mesh_spec, run_mesh

SEED = 17


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--sizes", default=None, help="comma-separated D (default 1,2,4; 1,2,4,8 on cpu)")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_mesh_scaling: no CUDA device (pass --device cpu for the host)")
    sizes = [int(d) for d in (args.sizes or ("1,2,4,8" if device.type == "cpu" else "1,2,4")).split(",")]

    from plonky2_bn254_tpu_torch.prover import prove as prove_mod
    from plonky2_bn254_tpu_torch.prover import verify as verify_mod
    from plonky2_bn254_tpu_torch.prover.config import TEST_CONFIG

    reps = 2 if device.type == "cuda" else 1
    stark, inputs, ctl = fq_exp_inputs(SEED)
    trace = fq_exp_trace(inputs, device)
    rows = []
    reference = None
    with tempfile.TemporaryDirectory() as tmp:
        for D in sizes:
            if D == 1:
                for _ in range(reps):
                    if device.type == "cuda":
                        torch.cuda.synchronize()
                        torch.cuda.reset_peak_memory_stats()
                    t0 = time.perf_counter()
                    proof = prove_mod.prove(stark, trace, ctl, TEST_CONFIG, device_fs=False)
                    if device.type == "cuda":
                        torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                verify_mod.verify(stark, proof, ctl, TEST_CONFIG)
                reference = as_json(proof)
                peak = [torch.cuda.max_memory_allocated() / 1e9] if device.type == "cuda" else ["n/m"]
                ranks = [{"wall_s": wall, "peak_gb": peak[0], "bytes_sent": 0}]
            else:
                if reference is None:
                    reference = as_json(prove_mod.prove(stark, trace, ctl, TEST_CONFIG))
                ranks = run_mesh(trace, ctl, D, mesh_spec(device, reps=reps), tmp)
                check_same(ranks, reference, f"D = {D}")
            rows.append({"D": D, "wall_s": max(r["wall_s"] for r in ranks),
                         "peak_gb": [r["peak_gb"] for r in ranks],
                         "bytes_sent": [r["bytes_sent"] for r in ranks]})
            print(f"D = {D}: wall {rows[-1]['wall_s']:.3f} s, peak per rank "
                  f"{rows[-1]['peak_gb']} GB, bytes sent per rank {rows[-1]['bytes_sent']}",
                  flush=True)
    print("| ranks | prove wall s (last proof) | peak per rank GB | bytes sent per rank | bit-identical |")
    print("|---|---|---|---|---|")
    for r in rows:
        same = "(reference)" if r["D"] == 1 else "yes"
        peaks = ", ".join(p if isinstance(p, str) else f"{p:.2f}" for p in r["peak_gb"])
        print(f"| {r['D']} | {r['wall_s']:.3f} | {peaks} | {', '.join(map(str, r['bytes_sent']))} "
              f"| {same} |")
    print(json.dumps({"device": str(device), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
