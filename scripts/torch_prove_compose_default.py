"""The composed product at DEFAULT_CONFIG on one card, narrated step by step.

    python3 scripts/torch_prove_compose_default.py

The port's counterpart of scripts/prove_compose_default.py: the reference's
full user flow (build -> prove -> verify, the reference crate's
src/builder.rs:178-260) at the DEFAULT_CONFIG parameter class (84 query
rounds, cap height 4, arity 16, 16-bit PoW): two fq_exp ops -> the
recursive FqExp verifier at DEFAULT_CONFIG -> witness generation (the inner
STARK proved on the card, self-verified, injected) -> one outer
universal-gate proof over the 2^20-row outer trace, twice (the first meets
cold tables) -> verify_all, and a corrupted public value rejected.  The
steps are scripts/torch_bench_outer.py's `run` with one repeat; each prints
one "[t s] message" line.  Fails, exit non-zero, on any failed check or
without a CUDA card.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    from chip_smoke import require_card
    from torch_bench_outer import run

    device = require_card("torch_prove_compose_default")
    t_start = time.perf_counter()

    def mark(msg: str) -> None:
        print(f"[{time.perf_counter() - t_start:7.1f}s] {msg}", flush=True)

    run(device, 1, mark)
    mark("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
