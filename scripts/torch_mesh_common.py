"""What the port's mesh scripts share: the FqExp production trace, one
rank's timed proofs on a 1-D or 2-D mesh, and the proof comparison.

The ranks are spawned by `plonky2_bn254_tpu_torch.parallel.launch.run`;
every rank maps the trace from one `.npy` file, so no rank builds it.  On
the card every rank's blocks live on cuda:{rank % cards} (the ranks of one
card share it through gloo, which moves host tensors); with `device="cpu"`
on the host.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def fq_exp_inputs(seed: int):
    """One FqExp op from `default_rng(seed)`, as the reference's mesh
    scripts draw it: (stark, inputs, CTL values)."""
    from plonky2_bn254_tpu_torch.bn254 import oracle
    from plonky2_bn254_tpu_torch.starks import fq_exp
    from plonky2_bn254_tpu_torch.starks.table import fq_exp_stark

    rng = np.random.default_rng(seed)
    s = int(rng.integers(1, 1 << 62)) << 150 | int(rng.integers(0, 1 << 62))
    inputs = [(s, oracle.random_fq(rng), 0)]
    return fq_exp_stark(), inputs, fq_exp.generate_ctl_values(inputs)


def fq_exp_trace(inputs, device) -> torch.Tensor:
    from plonky2_bn254_tpu_torch.starks import fq_exp

    trace = fq_exp.generate_trace(inputs, device=device)
    assert tuple(trace.shape) == (1 << 16, 427), trace.shape
    return trace


def as_json(proof) -> str:
    from plonky2_bn254_tpu_torch.interop import proof_to_fields

    return json.dumps(proof_to_fields(proof), default=lambda v: v.tolist())


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak_gb(device) -> float:
    """Peak device memory on a card; on the host the process's resident
    high-water mark since it started (VmHWM: ru_maxrss would carry the
    spawning parent's peak across exec)."""
    if device.type == "cuda":
        return torch.cuda.max_memory_allocated(device) / 1e9
    with open("/proc/self/status") as f:
        kb = next(int(line.split()[1]) for line in f if line.startswith("VmHWM:"))
    return kb * 1024 / 1e9


def prove_rank(rank: int, world: int, trace_file: str, ctl_values, spec: dict) -> dict:
    """One rank: the mesh of `spec` (`mesh_spec`), then `reps` proofs of
    the mapped trace at TEST_CONFIG with the host transcript, each between
    two barriers; the last one's wall, peak, bytes sent and proof."""
    import torch.distributed as dist

    from plonky2_bn254_tpu_torch.parallel import mesh as mesh_mod
    from plonky2_bn254_tpu_torch.prover import prove as prove_mod
    from plonky2_bn254_tpu_torch.prover.config import TEST_CONFIG
    from plonky2_bn254_tpu_torch.starks.table import fq_exp_stark

    if spec["device"] == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if spec["shape"] is None:
        mesh = mesh_mod.make_mesh(world, device=spec["device"])
    else:
        mesh = mesh_mod.make_mesh2d(spec["shape"], spec["axes"], device=spec["device"])
    trace = torch.from_numpy(np.load(trace_file, mmap_mode="c"))  # each rank reads its rows
    for _ in range(spec["reps"]):
        _sync(mesh.device)
        if mesh.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(mesh.device)
        mesh.reset_stats()
        dist.barrier()
        t0 = time.perf_counter()
        proof = prove_mod.prove(fq_exp_stark(), trace, ctl_values, TEST_CONFIG, mesh=mesh,
                                mesh_axis=spec["mesh_axis"])
        _sync(mesh.device)
        dist.barrier()
        wall = time.perf_counter() - t0
    return {"wall_s": wall, "peak_gb": _peak_gb(mesh.device),
            "bytes_sent": mesh.stats["bytes_sent"], "proof": as_json(proof)}


def mesh_spec(device, shape=None, axes=("tp", "dp"), mesh_axis=None, reps=2) -> dict:
    """What `prove_rank` builds: the ranks' device (None: the card's
    default, or "cpu"), a 1-D mesh (`shape` None) or a 2-D one of `shape`
    over `axes`, the axes the rows split over, the proofs a rank makes."""
    return {"device": None if device.type == "cuda" else "cpu", "shape": shape, "axes": axes,
            "mesh_axis": mesh_axis, "reps": reps}


def run_mesh(trace: torch.Tensor, ctl_values, world: int, spec: dict, tmp: str,
             timeout: float = 1800.0) -> list:
    """Every rank's `prove_rank` record, the trace written once to `tmp`."""
    from plonky2_bn254_tpu_torch import kernels
    from plonky2_bn254_tpu_torch.parallel import launch

    trace_file = os.path.join(tmp, "trace.npy")
    if not os.path.exists(trace_file):
        np.save(trace_file, trace.cpu().numpy())
    if spec["device"] is None:
        kernels.library()  # built once here, loaded by the ranks
    return launch.run(prove_rank, world, trace_file, ctl_values, spec, timeout=timeout)


def check_same(ranks: list, want: str, what: str) -> None:
    """Raise unless every rank's proof is `want` (a proof's `as_json`)."""
    for r, res in enumerate(ranks):
        if res["proof"] != want:
            raise AssertionError(f"{what}: rank {r}'s proof differs from the single-device proof")
