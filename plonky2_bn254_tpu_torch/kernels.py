"""Build, load and count the hand-written CUDA kernels under `csrc/`.

The kernels are compiled at first use with `nvcc` for sm_90a, one `nvcc`
process a source, all started together, and linked into a shared library
with a plain C interface (`_build/`, listed in `.gitignore`) loaded with
ctypes; nothing here imports a PyTorch extension.  Importing this module
builds nothing: `library()` does, on the first launch.

Every wrapper calls `count_launch` where it launches its kernel, and
nowhere else: one more in `LAUNCHES`, and the call's shape in `CALLS`, so a
run can show which kernels it went through and at which shapes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
from collections import Counter

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
SOURCES = ("poseidon.cu", "ntt.cu", "quotient.cu", "inverse.cu", "combine.cu")
HEADERS = ("goldilocks.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_COMPILE_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-shared")

# K1 Poseidon leaf sponge, K1m Merkle levels (K1's Merkle use: every level
# below the regime threshold in one launch), K2 raw permutation, K2t one
# transcript transition (absorb and squeeze on one sponge state), K3
# NTT/iNTT, K4 coset LDE, K5 the quotient's constraints (a machine's tape
# at every coset point), K6 a batch of inverses, K7 the extension-weighted
# sums (a batch's openings at zeta and zeta g; the FRI oracle).
KERNEL_IDS = ("K1", "K1m", "K2", "K2t", "K3", "K4", "K5", "K6", "K7")
LAUNCHES: Counter = Counter({k: 0 for k in KERNEL_IDS})
# kernel id -> Counter of the keys its launches were made with (see the wrappers)
CALLS: dict = {k: Counter() for k in KERNEL_IDS}

_VP = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_U64 = ctypes.c_uint64
_SIGNATURES = {
    "p2_poseidon_init": (_VP,) * 7,
    "p2_poseidon_occupancy": (_VP,),
    "p2_hash_leaves": (_VP, _VP, _I64, _I64, _INT, _VP),
    "p2_permute_states": (_VP, _VP, _I64, _INT, _VP),
    "p2_tree_levels": (_VP, _VP, _I64, _INT, _VP, _VP),
    "p2_tree_counters": (_I64,),
    "p2_sponge_transition": (_VP, _VP, _VP, _VP, _INT, _VP, _INT, _INT, _INT, _VP),
    "p2_ntt_rows": (_VP, _VP, _VP, _VP, _I64, _INT, _INT, _INT, _INT, _U64, _VP),
    "p2_ntt_columns": (_VP, _VP, _VP, _VP, _VP, _I64, _INT, _INT, _INT, _INT, _VP),
    "p2_ntt_rows_t": (_VP, _VP, _VP, _I64, _INT, _INT, _INT, _VP),
    "p2_quotient_max_slots": (),
    "p2_quotient_tape": (_VP, _INT, _VP, _INT, _VP, _INT, _VP, _INT, _INT,
                         _VP, _VP, _I64, _VP, _VP, _I64, _VP, _VP, _I64, _VP),
    "p2_batch_inverse_block": (),
    "p2_batch_inverse": (_VP, _VP, _I64, _VP),
    "p2_combine_threads": (),
    "p2_combine_max_tile": (),
    "p2_combine_max_batches": (),
    "p2_combine_openings": (_VP, _I64, _I64, _VP, _VP, _INT, _INT, _VP, _VP, _VP),
    "p2_combine_norms": (_I64, _VP, _VP, _I64, _VP, _VP),
    "p2_combine_oracle": (_VP, _VP, _INT, _I64, _VP, _I64, _INT, _I64, _VP, _VP, _VP, _VP,
                          _I64, _VP, _VP, _VP),
}

# the others return a CUDA error code
_RESTYPES = {"p2_tree_counters": _I64, "p2_batch_inverse_block": _I64,
             "p2_combine_threads": _I64, "p2_combine_max_tile": _I64,
             "p2_combine_max_batches": _I64}


class BuildInfo:
    """The compiler's report of the last build and the library it loaded."""

    log: str = ""
    path: str = ""


BUILD = BuildInfo()


def reset_launches() -> None:
    for k in KERNEL_IDS:
        LAUNCHES[k] = 0
        CALLS[k].clear()


def count_launch(kernel_id: str, key: tuple) -> None:
    """One launch of `kernel_id`; `key` holds the shape of the call."""
    LAUNCHES[kernel_id] += 1
    CALLS[kernel_id][key] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Compile (once per source digest) and load the kernel library."""
    so = BUILD_DIR / f"libp2kernels_{_digest()}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        tag = f"{_digest()}.{os.getpid()}"
        objs = [BUILD_DIR / f"{src}.{tag}.o" for src in SOURCES]
        procs = [
            subprocess.Popen([nvcc, *_COMPILE_FLAGS, "-c", "-o", str(obj), str(CSRC / src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             cwd=str(CSRC))
            for src, obj in zip(SOURCES, objs)
        ]
        outs = [(src, proc.communicate()[0], proc.returncode) for src, proc in zip(SOURCES, procs)]
        BUILD.log = "".join(out for _, out, _ in outs)
        failed = [f"{src} ({rc})" for src, _, rc in outs if rc != 0]
        if failed:
            raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{BUILD.log}")
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True, cwd=str(CSRC))
        BUILD.log += res.stdout + res.stderr
        for obj in objs:
            obj.unlink(missing_ok=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{BUILD.log}")
        os.replace(tmp, so)
    BUILD.path = str(so)
    lib = ctypes.CDLL(str(so))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def require_cuda_int64(t: torch.Tensor, name: str, ndim: int = None) -> None:
    """Raise unless `t` is a contiguous int64 CUDA tensor (of rank `ndim`)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int64:
        raise ValueError(f"{name}: expected int64, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected rank {ndim}, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def is_plain(t: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain path); False for CUDA; raise else."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel or plain path for device {t.device}")
