"""NTT kernels K3 (NTT / iNTT) and K4 (coset LDE) for the H100.

Port of `plonky2_bn254_tpu/field/ntt_pallas.py` (`ntt`, `intt`,
`coset_lde_rate1`).  The kernels are `csrc/ntt.cu`; the plain versions
beside them are the tensor transforms of `ntt.py`.  Transforms run along the
last axis of `[..., n]`; a wrapper takes the plain path only for a CPU
tensor, and for a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from .. import kernels
from ..interop import tensor_from_u64
from . import goldilocks as gl
from . import ntt as ntt_plain_mod


@functools.lru_cache(maxsize=None)
def _twiddles(n_log: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """w_n^k for k < n/2 (w_n^-k for the inverse); one dummy word if n = 1."""
    w = gl.primitive_root_of_unity(n_log)
    if inverse:
        w = gl.h_inv(w)
    return tensor_from_u64(gl.powers(w, max(1, (1 << n_log) // 2)), device)


@functools.lru_cache(maxsize=None)
def _coset_table(n: int, shift: int, device: torch.device) -> torch.Tensor:
    return tensor_from_u64(ntt_plain_mod._coset_powers(n, shift), device)


def _log2(n: int, what: str) -> int:
    n_log = n.bit_length() - 1
    if n < 1 or n != 1 << n_log:
        raise ValueError(f"{what}: size {n} is not a power of two")
    return n_log


def _transform(x: torch.Tensor, out_n: int, inverse: bool, kernel_id: str,
               pre=None) -> torch.Tensor:
    """Launch the local tile kernel, then one stage kernel per stage that
    spans more than a tile, and count one launch of `kernel_id`.  `pre`:
    coset powers for the LDE premultiply."""
    lib = kernels.library()
    rows = x.shape[0]
    n_log = _log2(out_n, "ntt")
    src_log = _log2(x.shape[1], "ntt")
    tile_log = lib.p2_ntt_tile_log()
    tw = _twiddles(n_log, inverse, x.device)
    n_inv = pow(out_n, gl.P - 2, gl.P) if inverse and n_log > 0 else 1
    y = torch.empty((rows, out_n), dtype=torch.int64, device=x.device)
    if rows == 0:
        return y
    stream = kernels.stream_of(x)
    local_all = n_log <= tile_log
    kernels.check(
        lib.p2_ntt_local(x.data_ptr(), y.data_ptr(), tw.data_ptr(),
                         None if pre is None else pre.data_ptr(), rows, n_log,
                         src_log, int(inverse and local_all and n_log > 0),
                         n_inv, stream),
        "ntt_local",
    )
    for s in range(tile_log + 1, n_log + 1):
        kernels.check(
            lib.p2_ntt_stage(y.data_ptr(), tw.data_ptr(), rows, n_log, s,
                             int(inverse and s == n_log), n_inv, stream),
            "ntt_stage",
        )
    kernels.LAUNCHES[kernel_id] += 1
    return y


def _as_rows(x: torch.Tensor, name: str):
    if x.dim() < 1:
        raise ValueError(f"{name}: expected at least one axis")
    return x.reshape(-1, x.shape[-1]), x.shape[:-1]


def ntt_plain(x: torch.Tensor) -> torch.Tensor:
    return ntt_plain_mod.ntt(x)


def intt_plain(x: torch.Tensor) -> torch.Tensor:
    return ntt_plain_mod.intt(x)


def coset_lde_plain(coeffs: torch.Tensor, rate_bits: int,
                    shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR) -> torch.Tensor:
    return ntt_plain_mod.coset_lde_from_coeffs(coeffs, rate_bits, shift)


def _ntt_kernel(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    kernels.require_cuda_int64(x, "intt" if inverse else "ntt")
    rows, lead = _as_rows(x, "ntt")
    y = _transform(rows, rows.shape[1], inverse, "K3")
    return y.reshape(lead + (x.shape[-1],))


def ntt(x: torch.Tensor) -> torch.Tensor:
    """Forward NTT along the last axis, natural order in and out (K3)."""
    if kernels.is_plain(x):
        return ntt_plain(x)
    return _ntt_kernel(x, inverse=False)


def intt(x: torch.Tensor) -> torch.Tensor:
    """Inverse NTT along the last axis, natural order in and out (K3)."""
    if kernels.is_plain(x):
        return intt_plain(x)
    return _ntt_kernel(x, inverse=True)


def coset_lde(coeffs: torch.Tensor, rate_bits: int,
              shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR) -> torch.Tensor:
    """[..., n] coefficients -> [..., n << rate_bits] values on shift * H (K4)."""
    if kernels.is_plain(coeffs):
        return coset_lde_plain(coeffs, rate_bits, shift)
    kernels.require_cuda_int64(coeffs, "coset_lde")
    rows, lead = _as_rows(coeffs, "coset_lde")
    n = rows.shape[1]
    pre = _coset_table(n, shift, coeffs.device)
    y = _transform(rows, n << rate_bits, False, "K4", pre=pre)
    return y.reshape(lead + (n << rate_bits,))
