"""ctypes bridge to the port's host Poseidon library (`csrc/host_poseidon.cpp`).

Port of `plonky2_bn254_tpu/field/native.py`.  The library is compiled with
the host C++ compiler at first use (`-O3 -fPIC -std=c++17`; no
`-march=native`, so a library built on one host loads on another) into
`_build/` (listed in `.gitignore`), named by the digest of the source and
the flags, and loaded once per process; importing this module builds
nothing.  The round constants and MDS matrix are installed from
`poseidon_constants.py`.

There is no fallback and no switch: if the compiler is missing or the build
or load fails, the first call raises.  The pure-python versions stay in
`poseidon.py` as `h_*_plain`, for the tests.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import List

import numpy as np

from .goldilocks import P
from .poseidon_constants import DIGEST_LEN, MDS, ROUND_CONSTANTS, WIDTH

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "csrc" / "host_poseidon.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_U64P = ctypes.POINTER(ctypes.c_uint64)
_SIGNATURES = {
    "gl_poseidon_init": ((_U64P, _U64P), None),
    "gl_poseidon_permute": ((_U64P,), None),
    "gl_poseidon_hash_no_pad": ((_U64P, ctypes.c_int, _U64P), None),
    "gl_poseidon_two_to_one": ((_U64P, _U64P, _U64P), None),
    "gl_poseidon_verify_path": ((_U64P, ctypes.c_uint64, _U64P, ctypes.c_int, _U64P),
                                ctypes.c_int),
}


def _cxx() -> str:
    found = shutil.which("g++") or shutil.which("c++")
    if not found:
        raise RuntimeError("no host C++ compiler (g++): the host Poseidon library cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Compile (once per source digest), load and initialise the library."""
    so = BUILD_DIR / f"libhostposeidon_{_digest()}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"host Poseidon build failed ({res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, (args, res_type) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = res_type
    rc = np.ascontiguousarray(ROUND_CONSTANTS, dtype=np.uint64)
    mds = np.ascontiguousarray(np.asarray(MDS).reshape(-1), dtype=np.uint64)
    lib.gl_poseidon_init(rc.ctypes.data_as(_U64P), mds.ctypes.data_as(_U64P))
    return lib


def _words(values) -> ctypes.Array:
    """Python ints (any size or sign) -> a ctypes u64 array of residues."""
    vals = [int(v) % P for v in values]
    return (ctypes.c_uint64 * len(vals))(*vals)


def permute(state) -> List[int]:
    """Poseidon permutation of 12 field elements."""
    if len(state) != WIDTH:
        raise ValueError(f"permute: expected {WIDTH} elements, got {len(state)}")
    buf = _words(state)
    library().gl_poseidon_permute(buf)
    return list(buf)


def hash_no_pad(inputs) -> List[int]:
    """Sponge hash of any number of field elements -> 4-element digest."""
    buf = _words(inputs)
    out = (ctypes.c_uint64 * DIGEST_LEN)()
    library().gl_poseidon_hash_no_pad(buf, len(buf), out)
    return list(out)


def two_to_one(left, right) -> List[int]:
    """Merkle compression of two 4-element digests."""
    if len(left) != DIGEST_LEN or len(right) != DIGEST_LEN:
        raise ValueError("two_to_one: digests have 4 elements")
    out = (ctypes.c_uint64 * DIGEST_LEN)()
    library().gl_poseidon_two_to_one(_words(left), _words(right), out)
    return list(out)


def verify_path(digest, index: int, path, cap_node) -> bool:
    """True when hashing `digest` up `path` (siblings, leaf level first) from
    leaf `index` ends at `cap_node`.  The words go in as given (u64), so a
    non-canonical cap word never matches, as in the python chain."""
    d, sib, cap = (np.ascontiguousarray(np.asarray(a, dtype=np.uint64).reshape(-1))
                   for a in (digest, path, cap_node))
    if sib.size != DIGEST_LEN * len(path) or d.size != DIGEST_LEN or cap.size != DIGEST_LEN:
        raise ValueError("verify_path: the digest, the cap node and every sibling have 4 elements")
    return bool(library().gl_poseidon_verify_path(
        d.ctypes.data_as(_U64P), int(index), sib.ctypes.data_as(_U64P), len(path),
        cap.ctypes.data_as(_U64P)))
