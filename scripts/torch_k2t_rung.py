"""K2t (the warp sponge-transition kernel of csrc/poseidon.cu) against its
one-thread rung (csrc/op_probe.cu: the same transition over `permute` in one
thread's registers) on one NVIDIA GPU.

    python scripts/torch_k2t_rung.py

At each transition key (pending words, absorbed words, pending outputs,
squeezes) below, on random words from numpy.random.default_rng(7) in one
device vector: both kernels' state, leftover words and outputs must equal
the plain version's bit for bit; each kernel is timed with CUDA events
(the median of its repeats) beside K2t's latency bound (bounds.py).  Prints
the card's name and power limit, one line per key, then one JSON line.
"""

import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from plonky2_bn254_tpu_torch import bounds, kernels  # noqa: E402
from plonky2_bn254_tpu_torch.field import poseidon_cuda as pc  # noqa: E402
from plonky2_bn254_tpu_torch.interop import tensor_from_u64  # noqa: E402

# G2's opening absorb (its longest chain), a FRI layer's cap and beta, the
# most launched key of the chip smoke's paths
KEYS = [(0, 8820, 6, 2), (0, 8, 6, 2), (0, 64, 6, 2)]


def cuda_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = bounds.probe_library(kernels.BUILD_DIR / "op_probe")
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.p2_poseidon_init.argtypes = [vp] * 7
    lib.p2_sponge_transition_1t.argtypes = [vp, vp, vp, vp, i32, vp, i32, i32, i32, vp]
    for f in (lib.p2_poseidon_init, lib.p2_sponge_transition_1t):
        f.restype = i32
    pc.install_constants(lib)

    rng = np.random.default_rng(7)
    print(card)
    rows = []
    for key in KEYS:
        n_pending, n_words, n_out, n_squeeze = key
        assert n_pending == 0
        state = tensor_from_u64(rng.integers(0, 2**64 - 2**32 + 1, 12, dtype=np.uint64), "cuda")
        words = tensor_from_u64(rng.integers(0, 2**64 - 2**32 + 1, n_words, dtype=np.uint64), "cuda")
        out = torch.empty(12 + 8 + n_squeeze, dtype=torch.int64, device="cuda")
        ptrs, lens = (ctypes.c_void_p * 1)(words.data_ptr()), (ctypes.c_int64 * 1)(n_words)

        def rung():
            kernels.check(lib.p2_sponge_transition_1t(
                state.data_ptr(), out.data_ptr(), ptrs, lens, 1, None, 0, n_out, n_squeeze,
                kernels.stream_of(state)), "rung")

        want = pc.sponge_transition_plain(state.cpu(), None, [words.cpu()], n_squeeze, n_out)
        got = pc.sponge_transition(state, None, [words], n_squeeze, n_out)
        rung()
        fill = len(want[1])
        got_rung = (out[:12], out[12 : 12 + fill], out[20:])
        for name, res in (("K2t", got), ("rung", got_rung)):
            if not all(torch.equal(g.cpu(), w) for g, w in zip(res, want)):
                raise AssertionError(f"{name} {key} differs from the plain version")
        ms = cuda_ms(lambda: pc.sponge_transition(state, None, [words], n_squeeze, n_out), 10)
        rung_ms = cuda_ms(rung, 3)
        ops, nbytes, perms, chain = bounds.sponge_transition_work(key)
        bound, _ = bounds.bound_ms(ops, nbytes, sms, clock_mhz, chain)
        row = {"key": list(key), "perms": perms, "k2t_ms": ms, "rung_ms": rung_ms,
               "k2t_us_per_perm": 1e3 * ms / perms, "rung_us_per_perm": 1e3 * rung_ms / perms,
               "bound_ms": bound, "share": bound / ms}
        rows.append(row)
        print(f"{key}: {perms} permutations, K2t {ms:.4f} ms ({row['k2t_us_per_perm']:.2f} us a "
              f"permutation), one-thread rung {rung_ms:.4f} ms ({row['rung_us_per_perm']:.2f} us), "
              f"latency bound {bound:.4f} ms, K2t share {bound / ms:.3f}; both equal the plain version")
    print(json.dumps({"card": card, "clock_mhz": clock_mhz, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
