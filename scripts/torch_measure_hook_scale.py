"""Hook batch scale: n fq_exp ops through one BN254 hook, on one card.

    python3 scripts/torch_measure_hook_scale.py [n_ops] [--fake]

The port's counterpart of scripts/measure_hook_scale.py, with its CONFIG
(rate 1, cap 1, 8-bit PoW, 4 queries, arity 4, final degree 2^3) and its
ops: n_ops (default 128) fq_exp ops from numpy.random.default_rng(128)
(s = r1 << 180 | r0).  128 ops x 512 rows fill one 2^16-row FqExp trace
exactly, so the STARK work equals a 1-op batch's; what grows with n_ops is
the circuit side: the ToU16 resplits, the CTL value targets and the
witness fixpoint.

Prints the recording and build seconds (host Python), the target count and
the constraint count (object constraints plus templated rows).  Then
generate_witness on the card (with the real backend: the batch FqExp proof,
self-verified and injected; with --fake the hook proves nothing, the
reference's not-constrain-bn254-stark mode) and Circuit.check on the card,
and every output against pow(x, s, P).  Needs a CUDA card: without one it
exits non-zero.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CONFIG = dict(num_challenges=2, rate_bits=1, cap_height=1, proof_of_work_bits=8,
              num_query_rounds=4, arity_bits=2, final_poly_degree_bits=3)
SEED = 128


def build(n_ops: int, prove: bool) -> dict:
    """Record `n_ops` fq_exp ops on one hook at CONFIG and build the
    circuit (with the recursive verifier unless `prove` is false): the
    builder, the circuit, the witness, (s, x, output target) per op, and the
    seconds of each part."""
    from plonky2_bn254_tpu_torch import circuit as ckt
    from plonky2_bn254_tpu_torch.bn254 import oracle
    from plonky2_bn254_tpu_torch.circuit import builder_ops
    from plonky2_bn254_tpu_torch.circuit.fq import FqTarget
    from plonky2_bn254_tpu_torch.prover.config import StarkConfig

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    b = ckt.CircuitBuilder()
    hook = builder_ops.get_bn254_hook(b)
    hook.stark_config = StarkConfig(**CONFIG)
    hook.prove_starks = prove
    pw = ckt.Witness()
    recorded = []
    for _ in range(n_ops):
        s_v = int(rng.integers(1, 1 << 62)) << 180 | int(rng.integers(0, 1 << 62))
        x_v = oracle.random_fq(rng)
        x_t = FqTarget.new_unchecked(b)
        out = builder_ops.fq_exp(b, s_v, x_t)
        x_t.set_witness(pw, x_v)
        recorded.append((s_v, x_v, out))
    record_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    circuit = b.build()
    return {"builder": b, "circuit": circuit, "witness": pw, "recorded": recorded,
            "record_s": record_s, "build_s": time.perf_counter() - t0}


def counts(builder) -> dict:
    """The circuit's size: targets, object constraints, templated rows."""
    return {"targets": builder.num_targets, "constraints": len(builder.constraints),
            "templated_rows": len(builder.tpl_rows)}


def main() -> int:
    import torch

    from bench_torch import device_record
    from chip_smoke import require_card
    from plonky2_bn254_tpu_torch.bn254 import params

    prove = "--fake" not in sys.argv
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    n_ops = int(args[0]) if args else 128
    device = require_card("torch_measure_hook_scale")
    record = device_record(device)
    print(f"# card: {record['name']}, {record['power_limit']}", flush=True)

    built = build(n_ops, prove)
    c = counts(built["builder"])
    print(f"n_ops={n_ops} record={built['record_s']:.2f}s build={built['build_s']:.2f}s "
          f"targets={c['targets']} constraints~={c['constraints'] + c['templated_rows']} "
          f"(objects {c['constraints']}, templated rows {c['templated_rows']}) "
          f"backend={'REAL' if prove else 'fake'}", flush=True)

    t0 = time.perf_counter()
    values = built["circuit"].generate_witness(built["witness"], device)
    torch.cuda.synchronize(device)
    witness_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    built["circuit"].check(values, device)
    torch.cuda.synchronize(device)
    check_s = time.perf_counter() - t0
    for s_v, x_v, out in built["recorded"]:
        if out.get_witness(values) != pow(x_v, s_v, params.P):
            raise AssertionError("an fq_exp output differs from pow(x, s, P)")
    print(f"witness={witness_s:.2f}s check={check_s:.2f}s -- all {n_ops} outputs match "
          "the native oracle", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
