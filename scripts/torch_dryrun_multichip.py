"""The port's multi-device dry run, the analog of
`__graft_entry__.dryrun_multichip(n)`:

    python3 scripts/torch_dryrun_multichip.py 8 --device cpu   # 8 gloo ranks on the host
    python3 scripts/torch_dryrun_multichip.py 4                # 4 gloo ranks sharing the card

On an n-rank 1-D mesh (n a power of two >= 2): the demo STARK (TEST_CONFIG)
proved by `prove(..., mesh=...)`, verified and held equal to its
single-device proof; `distributed_ntt` of a [32, 8 n] matrix against
`single_device_reference`; then the production FqExp machine (2^16 x 427,
one op) proved on the full mesh, verified and held equal to its
single-device proof.  Any mismatch raises; the exit code is then non-zero.
"""

import argparse
import json
import sys
import tempfile
import time

import numpy as np
import torch

from torch_mesh_common import as_json, check_same, fq_exp_inputs, fq_exp_trace, mesh_spec, run_mesh

SEED = 1


def demo_rank(rank: int, world: int, device, x: np.ndarray) -> dict:
    """One rank: the demo proof on the mesh and its block of distributed_ntt."""
    from plonky2_bn254_tpu_torch.interop import tensor_from_u64, u64_from_tensor
    from plonky2_bn254_tpu_torch.parallel import mesh as mesh_mod
    from plonky2_bn254_tpu_torch.parallel import ntt as pntt
    from plonky2_bn254_tpu_torch.prover import prove as prove_mod
    from plonky2_bn254_tpu_torch.prover.config import TEST_CONFIG
    from plonky2_bn254_tpu_torch.starks.demo import demo_stark, demo_trace

    if device == "cpu":
        torch.set_num_threads(1)
    mesh = mesh_mod.make_mesh(world, device=device)
    trace, ctl = demo_trace(np.random.default_rng(SEED))
    proof = prove_mod.prove(demo_stark(), trace, ctl, TEST_CONFIG, mesh=mesh)
    blk = pntt.distributed_ntt(mesh_mod.shard_cols(mesh, tensor_from_u64(x)), mesh)
    return {"proof": as_json(proof), "ntt": u64_from_tensor(blk)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, nargs="?", default=8, help="ranks (default 8)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args()
    n, device = args.n, torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_dryrun_multichip: no CUDA device (pass --device cpu for the host)")

    from plonky2_bn254_tpu_torch import kernels
    from plonky2_bn254_tpu_torch.field import goldilocks as gl
    from plonky2_bn254_tpu_torch.interop import proof_from_fields, tensor_from_u64, u64_from_tensor
    from plonky2_bn254_tpu_torch.parallel import launch
    from plonky2_bn254_tpu_torch.parallel import ntt as pntt
    from plonky2_bn254_tpu_torch.prover import prove as prove_mod
    from plonky2_bn254_tpu_torch.prover import verify as verify_mod
    from plonky2_bn254_tpu_torch.prover.config import TEST_CONFIG
    from plonky2_bn254_tpu_torch.starks.demo import demo_stark, demo_trace

    rank_device = None if device.type == "cuda" else "cpu"
    if rank_device is None:
        kernels.library()  # built once here, loaded by the ranks
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    x = rng.integers(0, gl.P, size=(32, 8 * n), dtype=np.uint64)
    ranks = launch.run(demo_rank, n, rank_device, x, timeout=900)
    trace, ctl = demo_trace(np.random.default_rng(SEED))
    single = prove_mod.prove(demo_stark(), trace.to(device), ctl, TEST_CONFIG)
    check_same(ranks, as_json(single), "demo")
    verify_mod.verify(demo_stark(), proof_from_fields(json.loads(ranks[0]["proof"])), ctl,
                      TEST_CONFIG)
    want = u64_from_tensor(pntt.single_device_reference(tensor_from_u64(x, device)))
    np.testing.assert_array_equal(np.concatenate([r["ntt"] for r in ranks], axis=0), want)
    print(f"torch_dryrun_multichip({n}): demo STARK prove+verify (sharded, equal to the "
          f"single-device proof) + all-to-all NTT OK on {n} gloo ranks ({device}), "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    stark, inputs, ctl = fq_exp_inputs(SEED)
    trace = fq_exp_trace(inputs, device)
    single = as_json(prove_mod.prove(stark, trace, ctl, TEST_CONFIG))
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_mesh(trace, ctl, n, mesh_spec(device, reps=1), tmp)
    check_same(ranks, single, "FqExp")
    verify_mod.verify(stark, proof_from_fields(json.loads(ranks[0]["proof"])), ctl, TEST_CONFIG)
    print(f"torch_dryrun_multichip({n}): production FqExp (2^16 x 427) prove+verify on the "
          f"{n}-rank mesh, equal to the single-device proof, {time.perf_counter() - t0:.1f} s "
          f"(mesh proof {max(r['wall_s'] for r in ranks):.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
