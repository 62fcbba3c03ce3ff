"""The production FqExp machine proved on a 2-D mesh by the port, as
scripts/mesh2d_production.py does with the JAX package: the 2^16 x 427
trace of one op from default_rng(1), at TEST_CONFIG, on a mesh over
("dp", "tp") with the rows split over both axes.

    python3 scripts/torch_mesh2d_production.py                 # the card: a (2, 2) mesh
    python3 scripts/torch_mesh2d_production.py --device cpu    # the host: a (2, 4) mesh

The proof must verify and equal the single-device proof field by field on
every rank, or the script raises.  Prints both walls (the mesh's barrier
to barrier, on the card the second of two proofs), each rank's peak and
bytes.
"""

import argparse
import json
import sys
import tempfile
import time

import torch

from torch_mesh_common import as_json, check_same, fq_exp_inputs, fq_exp_trace, mesh_spec, run_mesh

SEED = 1
AXES = ("dp", "tp")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--shape", default=None, help="the mesh shape, e.g. 2x4 (default 2x2; 2x4 on cpu)")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_mesh2d_production: no CUDA device (pass --device cpu for the host)")
    shape = tuple(int(v) for v in (args.shape or ("2x4" if device.type == "cpu" else "2x2")).split("x"))

    from plonky2_bn254_tpu_torch.interop import proof_from_fields
    from plonky2_bn254_tpu_torch.prover import prove as prove_mod
    from plonky2_bn254_tpu_torch.prover import verify as verify_mod
    from plonky2_bn254_tpu_torch.prover.config import TEST_CONFIG

    stark, inputs, ctl = fq_exp_inputs(SEED)
    trace = fq_exp_trace(inputs, device)
    t0 = time.perf_counter()
    single = as_json(prove_mod.prove(stark, trace, ctl, TEST_CONFIG))
    print(f"single-device prove: {time.perf_counter() - t0:.3f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_mesh(trace, ctl, shape[0] * shape[1],
                         mesh_spec(device, shape=shape, axes=AXES, mesh_axis=AXES,
                                   reps=2 if device.type == "cuda" else 1), tmp)
    print(f"2-D {shape} mesh over {AXES} prove: {max(r['wall_s'] for r in ranks):.3f} s; peak per "
          f"rank {[round(r['peak_gb'], 3) for r in ranks]} GB; bytes sent per rank "
          f"{[r['bytes_sent'] for r in ranks]}", flush=True)
    check_same(ranks, single, f"2-D mesh {shape}")
    verify_mod.verify(stark, proof_from_fields(json.loads(ranks[0]["proof"])), ctl, TEST_CONFIG)
    print("2-D mesh production proof verified + bit-identical to single-device", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
