"""K1 (leaf sponge), K1m (Merkle levels) and K2 (permutation) of
csrc/poseidon.cu in both regimes, against their plain versions and their
bounds, on one NVIDIA GPU.

    python3 scripts/torch_poseidon_regimes.py [--parent-csrc DIR] [--out PATH]

1. Builds the kernel library, and poseidon.cu once more for each value of
   P2_TP_MIN_BLOCKS in VARIANTS (the throughput kernels' __launch_bounds__
   minimum blocks an SM; the library's default among them), one nvcc a
   build, all started together; prints each build's ptxas lines
   (registers, spills).
   With --parent-csrc, also builds the poseidon.cu in DIR (an earlier
   revision with the one-thread dense kernels and the two-argument
   p2_poseidon_init) for the same keys.
2. Every kernel and build must equal the plain version bit for bit on
   random words (seed 7) at each key timed.
3. Times (CUDA events, the median of REPS after a warm-up; builds in turns
   earlier, default, default, earlier, so a drift of the card shows):
   K1 at the main path's keys and at w = 8 from 2^8 to 2^17 rows in each
   regime, K2 at [2^20, 12] and [4096, 12] and 2^12..2^17 rows in each
   regime, each throughput variant at the large keys, and the Merkle levels
   of the main path's trees as the prover builds them now
   (`hash_tree_levels`: K1 for the levels that fill the card, one K1m
   launch for the rest) beside one K1 launch a level; each with its bound
   (bounds.py) and share.  For the keys of at most 2^14 rows and the trees
   also each run's device time in the Poseidon kernels (torch.profiler)
   and its host time a call: a small launch's event time can be the
   wrapper's host path.

Prints the card's name and power limit, a line per measurement, and one
JSON line (also written to --out).  Needs a CUDA card: without one it exits
non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from plonky2_bn254_tpu_torch import bounds, kernels  # noqa: E402
from plonky2_bn254_tpu_torch.field import poseidon_cuda as pc  # noqa: E402
from plonky2_bn254_tpu_torch.field.poseidon_constants import MDS, ROUND_CONSTANTS  # noqa: E402
from plonky2_bn254_tpu_torch.interop import tensor_from_u64  # noqa: E402

VARIANTS = (2, 3, 4)  # P2_TP_MIN_BLOCKS builds (the library's default among them)
REPS = 10
# K1 keys of the main paths (PERF.md): trace and aux leaves of the
# machines and the outer proof, the mesh's aux block, FRI layer leaves
K1_PATH_KEYS = [(1 << 21, 108), (1 << 17, 781), (1 << 17, 456), (1 << 15, 134),
                (8192, 32), (512, 32), (64, 16)]
K1_ROWS_W8 = [1 << k for k in range(8, 18)] + [5 << 12, 3 << 13, 7 << 12, 3 << 14]
K2_ROWS = [1 << 20] + [1 << k for k in range(12, 18)]
# (digests, levels): the trees of a 2^17-leaf commit to cap 4, the outer
# proof's 2^21-leaf commit, FRI layers
TREES = [(1 << 17, 13), (1 << 21, 17), (1 << 14, 10), (8192, 9), (512, 5), (64, 2)]
BIG = (1 << 21, 108)  # not timed in the latency regime
POSEIDON_KERNELS = ("hash_leaves", "permute_states", "tree_levels")  # in the profiler's kernel names


def cuda_ms(fn, reps: int = REPS) -> float:
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


def device_ms(fn, reps: int = REPS):
    """Mean device time a call of `fn` spends in this library's Poseidon
    kernels, from torch.profiler's CUDA activity (None if it saw none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
             for e in prof.key_averages() if any(k in e.key for k in POSEIDON_KERNELS))
    return us / 1e3 / reps if us else None


def host_ms(fn, reps: int = 50) -> float:
    """Host time of one call of `fn` (launches are asynchronous: this is
    the wrapper's own path, queueing included)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return ms


def nvidia_smi(fields: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader,nounits"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def build(src: pathlib.Path, out_dir: pathlib.Path, name: str, defines=()):
    """nvcc of one poseidon.cu into lib<name>.so: (Popen, path)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"lib{name}.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, *[f"-D{d}" for d in defines], "-o", str(so),
           str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=str(src.parent)), so


def ptxas_lines(log: str) -> list:
    """The ptxas lines of log: each kernel's entry and its registers."""
    keep = []
    for line in log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            keep.append(line.strip())
    return keep


class Lib:
    """A build of poseidon.cu loaded with ctypes, its constants installed;
    `old`: the earlier revision's interface (no regime, two tables)."""

    def __init__(self, so: pathlib.Path, old: bool):
        self.lib, self.old = ctypes.CDLL(str(so)), old
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        sigs = {"p2_hash_leaves": [vp, vp, i64, i64] + ([] if old else [i32]) + [vp],
                "p2_permute_states": [vp, vp, i64] + ([] if old else [i32]) + [vp],
                "p2_poseidon_init": [vp] * (2 if old else 7)}
        for fn, args in sigs.items():
            getattr(self.lib, fn).argtypes = args
            getattr(self.lib, fn).restype = i32
        if old:
            rc = np.ascontiguousarray(ROUND_CONSTANTS, dtype=np.uint64)
            mds = np.ascontiguousarray(MDS, dtype=np.uint32)
            kernels.check(self.lib.p2_poseidon_init(rc.ctypes.data, mds.ctypes.data), "init")
        else:
            pc.install_constants(self.lib)

    def hash_leaves(self, x, regime: int = 0):
        out = torch.empty((x.shape[0], 4), dtype=torch.int64, device=x.device)
        args = [x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1]] + ([] if self.old else [regime])
        kernels.check(self.lib.p2_hash_leaves(*args, kernels.stream_of(x)), "hash_leaves")
        return out

    def permute_states(self, x, regime: int = 0):
        out = torch.empty_like(x)
        args = [x.data_ptr(), out.data_ptr(), x.shape[0]] + ([] if self.old else [regime])
        kernels.check(self.lib.p2_permute_states(*args, kernels.stream_of(x)), "permute_states")
        return out


def rand(rng, shape):
    return tensor_from_u64(rng.integers(0, 2**64 - 1, size=shape, dtype=np.uint64, endpoint=True),
                           "cuda")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent-csrc", type=pathlib.Path, default=None)
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = nvidia_smi("name,power.limit")
    clock_mhz = float(nvidia_smi("clocks.max.sm"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(card)
    device = torch.device("cuda", 0)

    # ---- builds ------------------------------------------------------------
    out_dir = kernels.BUILD_DIR / "poseidon_variants"
    jobs = {f"min_blocks_{v}": build(kernels.CSRC / "poseidon.cu", out_dir, f"min_blocks_{v}",
                                     [f"P2_TP_MIN_BLOCKS={v}"]) for v in VARIANTS}
    if args.parent_csrc is not None:
        jobs["earlier"] = build(args.parent_csrc.resolve() / "poseidon.cu", out_dir, "earlier")
    kernels.library()
    builds, libs = {}, {}
    for name, (proc, so) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        builds[name] = ptxas_lines(log)
        libs[name] = Lib(so, old=name == "earlier")
    for name, lines in builds.items():
        print(f"# ptxas, {name}:")
        for line in lines:
            print(f"  {line}")
    print(f"# regime thresholds: K1 {pc.device_threshold('K1', device)} rows, "
          f"K2 {pc.device_threshold('K2', device)} rows ({sms} SMs, blocks an SM "
          f"{pc.occupancy(device)})")

    rng = np.random.default_rng(7)
    rows_out = []
    earlier = libs.get("earlier")

    def measure(kind, key, runs: dict, want, bound, small: bool = False):
        """Check every run against `want`, time them in turns (in order,
        then in reverse; the faster of the two for each), record; `small`:
        also each run's device time in the Poseidon kernels (profiler) and
        its host time a call, since a small launch's event time can be the
        host's."""
        for name, fn in runs.items():
            if not torch.equal(fn(), want):
                raise AssertionError(f"{kind} {key} {name} differs from the plain version")
        times = {}
        for name in list(runs) + list(runs)[::-1]:
            ms = cuda_ms(runs[name])
            times[name] = min(ms, times.get(name, ms))
        ms_b, by = bound
        row = {"kind": kind, "key": list(key), "ms": times, "bound_ms": ms_b, "bound_by": by,
               "share": {k: ms_b / v for k, v in times.items()}}
        line = (f"{kind} {key}: " + ", ".join(f"{k} {v:.4f} ms (share {ms_b / v:.3f})"
                                              for k, v in times.items())
                + f"; bound {ms_b:.4f} ms ({by})")
        if small:
            row["device_ms"] = {name: device_ms(fn) for name, fn in runs.items()}
            row["host_ms"] = {name: host_ms(fn) for name, fn in runs.items()}
            line += "; device " + ", ".join(
                f"{k} {v:.4f}" if v is not None else f"{k} n/a" for k, v in row["device_ms"].items())
            line += "; host a call " + ", ".join(f"{k} {v:.4f}" for k, v in row["host_ms"].items())
        rows_out.append(row)
        print(line)

    def bound_of(work):
        ops, nbytes, chain = work
        return bounds.bound_ms(ops, nbytes, sms, clock_mhz, chain)

    def variant_runs(method, x):
        return {f"min_blocks_{v}": (lambda lib: lambda: getattr(lib, method)(x))(libs[f"min_blocks_{v}"])
                for v in VARIANTS}

    # ---- K1 -----------------------------------------------------------------
    for key in K1_PATH_KEYS + [(r, 8) for r in K1_ROWS_W8]:
        x = rand(rng, key)
        runs = {} if earlier is None else {"earlier": lambda: earlier.hash_leaves(x)}
        runs["throughput"] = lambda: pc.launch_hash_leaves(x, "throughput")
        if key != BIG:
            runs["latency"] = lambda: pc.launch_hash_leaves(x, "latency")
        if key[0] >= 1 << 15 and key[1] > 8:
            runs.update(variant_runs("hash_leaves", x))
        measure(f"K1 ({pc.device_regime('K1', key[0], device)})", key, runs,
                pc.hash_leaves_plain(x), bound_of(bounds.hash_leaves_work(*key)),
                small=key[0] <= 1 << 14)
        del x
        torch.cuda.empty_cache()

    # ---- K2 -----------------------------------------------------------------
    for n in K2_ROWS:
        x = rand(rng, (n, 12))
        runs = {} if earlier is None else {"earlier": lambda: earlier.permute_states(x)}
        runs["throughput"] = lambda: pc.launch_permute_states(x, "throughput")
        runs["latency"] = lambda: pc.launch_permute_states(x, "latency")
        if n == 1 << 20:
            runs.update(variant_runs("permute_states", x))
        measure(f"K2 ({pc.device_regime('K2', n, device)})", (n,), runs,
                pc.permute_states_plain(x), bound_of(bounds.permute_states_work(n)),
                small=n <= 1 << 14)

    # ---- Merkle levels ------------------------------------------------------
    for n, levels in TREES:
        d = rand(rng, (n, 4))

        def per_level(hash_rows):
            cur, out = d, []
            for _ in range(levels):
                cur = hash_rows(cur.reshape(-1, 8))
                out.append(cur)
            return torch.cat(out)

        runs = {} if earlier is None else {"earlier, one K1 a level": lambda: per_level(earlier.hash_leaves)}
        runs["hash_tree_levels"] = lambda: torch.cat(pc.hash_tree_levels(d, levels))
        runs["one K1 a level"] = lambda: per_level(lambda r: pc.launch_hash_leaves(r, "throughput"))
        kernels.reset_launches()
        pc.hash_tree_levels(d, levels)
        launches = {k: kernels.LAUNCHES[k] for k in ("K1", "K1m")}
        measure(f"tree, launches {launches} (was {levels} K1)", (n, levels), runs,
                torch.cat(pc.hash_tree_levels_plain(d, levels)),
                bounds.tree_levels_bound_ms(n, levels, sms, clock_mhz), small=True)

    result = {"card": card, "clock_mhz": clock_mhz, "sms": sms,
              "thresholds": {k: pc.device_threshold(k, device) for k in ("K1", "K2")},
              "occupancy": pc.occupancy(device), "ptxas": builds, "rows": rows_out}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
