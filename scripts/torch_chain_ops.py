"""Tensor ops, device kernels and time per Jacobian chain step of the PyTorch
port's G1 and G2 trace generation, and ops per whole trace of each machine.

    python scripts/torch_chain_ops.py        # on the card if there is one, else the CPU

For one doubling and one mixed-add step over 128 ops (the batch of
chip_smoke.py) it counts every ATen op dispatched (views included) with a
TorchDispatchMode; on a card it also counts the device kernels that
torch.profiler records over the same step and times the step (8 steps, host
clock around work that ends in a synchronise).  For one op of each machine it
counts the ops that generate_trace dispatches (the count per step does not
depend on the batch).  Prints one JSON line.
"""

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from plonky2_bn254_tpu_torch.bn254 import oracle  # noqa: E402
from plonky2_bn254_tpu_torch.starks import (  # noqa: E402
    fq2_alg, fq_exp, g1_scalar_mul, g2_scalar_mul, jacobian)
from plonky2_bn254_tpu_torch.starks.limbs import from_ints  # noqa: E402

N_OPS = 128


class CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def dispatched(fn) -> int:
    with CountOps() as c:
        fn()
    return c.n


def device_kernels(fn) -> int:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def step_ms(fn, reps: int = 8) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def main() -> int:
    card = torch.cuda.is_available()
    dev = torch.device("cuda", 0) if card else torch.device("cpu")
    rng = np.random.default_rng(2024)
    g1 = [oracle.random_g1(rng) for _ in range(N_OPS)]
    g2 = [oracle.random_g2(rng) for _ in range(N_OPS)]

    X1 = from_ints([p[0] for p in g1], device=dev)
    Y1 = from_ints([p[1] for p in g1], device=dev)
    Z1 = torch.zeros_like(X1)
    Z1[:, 0] = 1

    def f2(vals):
        return torch.stack([from_ints([v[0] for v in vals], device=dev),
                            from_ints([v[1] for v in vals], device=dev)])

    X2, Y2 = f2([p[0] for p in g2]), f2([p[1] for p in g2])
    Z2 = torch.zeros_like(X2)
    Z2[0, :, 0] = 1
    # a Jacobian point with Z != 1 plus a distinct affine point
    J1, J2 = jacobian.double(X1, Y1, Z1), fq2_alg.jac_double(X2, Y2, Z2)
    steps = {
        "g1_double": lambda: jacobian.double(X1, Y1, Z1),
        "g1_mixed_add": lambda: jacobian.mixed_add(*J1, X1, Y1),
        "g2_double": lambda: fq2_alg.jac_double(X2, Y2, Z2),
        "g2_mixed_add": lambda: fq2_alg.jac_mixed_add(*J2, X2, Y2),
    }
    out = {"device": torch.cuda.get_device_name(0) if card else "cpu", "n_ops": N_OPS,
           "steps": {}}
    for name, fn in steps.items():
        row = {"dispatched_ops": dispatched(fn)}
        if card:
            row["device_kernels"] = device_kernels(fn)
            row["ms"] = step_ms(fn)
        out["steps"][name] = row

    s = (1 << 255) - 19
    one_op = {
        "g1": (g1_scalar_mul, [(s, g1[0], g1[1], 0)]),
        "fq_exp": (fq_exp, [(s, oracle.random_fq(rng), 0)]),
        "g2": (g2_scalar_mul, [(s, g2[0], g2[1], 0)]),
    }
    out["trace_dispatched_ops"] = {
        name: dispatched(lambda: mod.generate_trace(inputs, min_rows=512, device=dev))
        for name, (mod, inputs) in one_op.items()
    }
    if card:
        out["card"] = card_line()
    print(json.dumps(out))
    return 0


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


if __name__ == "__main__":
    sys.exit(main())
