"""The recursion circuit at DEFAULT_CONFIG: build cost and size, on one card.

    python3 scripts/torch_measure_default_recursion.py [kind] [n_ops]
    MEASURE_COMPILE_OUTER=1 python3 scripts/torch_measure_default_recursion.py

The port's counterpart of scripts/measure_default_recursion.py: the full
hook path (the ToU16 resplit and the in-circuit recursive STARK verifier of
the FqExp machine, 427 columns, 2^16 rows) at DEFAULT_CONFIG (84 query
rounds, cap height 4, arity 16, 16-bit PoW), for n_ops (default 1) ops of
`kind` (only fq_exp) from numpy.random.default_rng(7) (s = r1 << 150 |
r0).  Prints the recording and build seconds (host Python, one thread),
targets, object constraints, templated rows and templates, generators and
Poseidon ops.  With MEASURE_COMPILE_OUTER=1 it also compiles the outer
proof's layout and verifier key on the card (outer.compile_outer) and
prints its seconds, gate rows, Poseidon rows, trace rows and wires.  Needs
a CUDA card: without one it exits non-zero.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SEED = 7


def build(kind: str, n_ops: int) -> dict:
    """Record `n_ops` ops of `kind` on a CircuitBuilder whose hook proves at
    DEFAULT_CONFIG and build the circuit: the circuit and the seconds of
    recording and of the build."""
    from plonky2_bn254_tpu_torch.circuit import builder_ops
    from plonky2_bn254_tpu_torch.circuit.builder import CircuitBuilder
    from plonky2_bn254_tpu_torch.circuit.fq import FqTarget
    from plonky2_bn254_tpu_torch.prover.config import DEFAULT_CONFIG

    if kind != "fq_exp":
        raise SystemExit(f"unknown kind {kind}")
    rng = np.random.default_rng(SEED)
    builder = CircuitBuilder()
    hook = builder_ops.get_bn254_hook(builder)
    hook.stark_config = DEFAULT_CONFIG
    t0 = time.perf_counter()
    for _ in range(n_ops):
        x_t = FqTarget.new_unchecked(builder)
        s_v = int(rng.integers(1, 1 << 62)) << 150 | int(rng.integers(0, 1 << 62))
        builder_ops.fq_exp(builder, s_v, x_t)
    record_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    circuit = builder.build()  # emits ToU16 and the recursive verifier
    return {"circuit": circuit, "record_s": record_s, "build_s": time.perf_counter() - t0}


def counts(builder) -> dict:
    return {"targets": builder.num_targets, "constraints": len(builder.constraints),
            "templated_rows": len(builder.tpl_rows), "templates": len(builder.templates),
            "generators": len(builder.generators), "poseidon_ops": len(builder.poseidon_ops)}


def main() -> int:
    import torch

    from bench_torch import device_record
    from chip_smoke import require_card

    kind = sys.argv[1] if len(sys.argv) > 1 else "fq_exp"
    n_ops = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    device = require_card("torch_measure_default_recursion")
    record = device_record(device)
    print(f"# card: {record['name']}, {record['power_limit']}", flush=True)

    built = build(kind, n_ops)
    c = counts(built["circuit"].builder)
    print(f"kind={kind} n_ops={n_ops} config=DEFAULT_CONFIG"
          f" (84 query rounds, cap 4, arity 16, pow 16)")
    print(f"record ops:         {built['record_s']:8.2f}s")
    print(f"build (verifier):   {built['build_s']:8.2f}s  python, single thread")
    print(f"targets:            {c['targets']:>10,}")
    print(f"constraints (obj):  {c['constraints']:>10,}")
    print(f"templated rows:     {c['templated_rows']:>10,}  ({c['templates']} templates)")
    print(f"generators:         {c['generators']:>10,}")
    print(f"poseidon ops:       {c['poseidon_ops']:>10,}", flush=True)

    if os.environ.get("MEASURE_COMPILE_OUTER"):
        from plonky2_bn254_tpu_torch.circuit import outer

        t0 = time.perf_counter()
        data = outer.compile_outer(built["circuit"], device=device)
        torch.cuda.synchronize(device)
        compile_s = time.perf_counter() - t0
        print(f"compile_outer:      {compile_s:8.2f}s  on {record['name']}")
        print(f"outer gate rows:    {data.n_gate_rows:>10,}")
        print(f"outer poseidon rows:{data.n_pos * outer.POS_BLOCK:>10,}  "
              f"({data.n_pos} permutations)")
        print(f"outer trace rows:   {1 << data.n_log:>10,}  (2^{data.n_log})")
        print(f"outer wires:        {data.n_wires:>10,}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
