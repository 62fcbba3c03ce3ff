"""Quotient kernel K5: a machine's constraint tape at every point of the
LDE coset, in one launch.

The kernel is `csrc/quotient.cu`; the plain version beside it is the tape
run instruction by instruction in plain torch (`tape.run`), the kernel's
emulation.  The wrapper takes the plain path only for a CPU tensor, and for
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..interop import tensor_from_u64
from .tape import Tape, run


def _device_tape(tape: Tape, device: torch.device):
    """(prog, uprog, consts) of `tape` on `device`, copied once."""
    got = tape.on_device.get(device)
    if got is None:
        got = tape.on_device[device] = (
            torch.from_numpy(tape.prog).to(device, non_blocking=True),
            torch.from_numpy(tape.uprog).to(device, non_blocking=True),
            tensor_from_u64(tape.consts, device),
        )
    return got


def _check_shapes(tape: Tape, t_loc, t_nxt, a_loc, a_nxt, sel, inputs) -> int:
    n = t_loc.shape[-1]
    want = {"t_loc": (tape.width, n), "t_nxt": (tape.width, n), "a_loc": (tape.aux_width, n),
            "a_nxt": (tape.aux_width, n), "sel": (4, n), "inputs": (tape.n_inputs,)}
    for name, x in zip(want, (t_loc, t_nxt, a_loc, a_nxt, sel, inputs)):
        if tuple(x.shape) != want[name]:
            raise ValueError(f"quotient_values: {name} has shape {tuple(x.shape)}, "
                             f"expected {want[name]}")
    return n


def quotient_values_plain(tape: Tape, t_loc, t_nxt, a_loc, a_nxt, sel, inputs,
                          nxt_shift: int = 0) -> torch.Tensor:
    """`quotient_values` in plain torch (`tape.run`)."""
    _check_shapes(tape, t_loc, t_nxt, a_loc, a_nxt, sel, inputs)
    if nxt_shift:
        t_nxt = torch.roll(t_nxt, -nxt_shift, dims=1)
        a_nxt = torch.roll(a_nxt, -nxt_shift, dims=1)
    return run(tape, t_loc, t_nxt, a_loc, a_nxt, sel, inputs)


def quotient_values(tape: Tape, t_loc, t_nxt, a_loc, a_nxt, sel, inputs,
                    nxt_shift: int = 0) -> torch.Tensor:
    """[n_out, n]: the tape's outputs (the alpha-combined constraints over
    Z_H, one row per challenge set) at the n points of `t_loc` [w, n] and
    `a_loc` [aux, n].  The next row's values of point i are column
    (i + nxt_shift) mod n of `t_nxt` / `a_nxt`: the LDEs themselves with
    the rate's shift, or a mesh rank's halo-extended next rows with 0.
    `sel` [4, n]: z_last, l_first, l_last, 1/Z_H; `inputs` the scalar
    inputs (`tape.scalar_inputs`)."""
    if kernels.is_plain(t_loc):
        return quotient_values_plain(tape, t_loc, t_nxt, a_loc, a_nxt, sel, inputs, nxt_shift)
    for name, x in zip(("t_loc", "t_nxt", "a_loc", "a_nxt", "sel", "inputs"),
                       (t_loc, t_nxt, a_loc, a_nxt, sel, inputs)):
        kernels.require_cuda_int64(x, f"quotient_values: {name}")
        if x.device != t_loc.device:
            raise ValueError(f"quotient_values: {name} on {x.device}, not {t_loc.device}")
    n = _check_shapes(tape, t_loc, t_nxt, a_loc, a_nxt, sel, inputs)
    lib = kernels.library()
    if tape.n_slots > lib.p2_quotient_max_slots():
        raise ValueError(f"quotient_values: the tape needs {tape.n_slots} slots, more than "
                         f"the kernel's {lib.p2_quotient_max_slots()}")
    prog, uprog, consts = _device_tape(tape, t_loc.device)
    out = torch.empty((tape.n_out, n), dtype=torch.int64, device=t_loc.device)
    kernels.check(
        lib.p2_quotient_tape(prog.data_ptr(), prog.shape[0], uprog.data_ptr(), uprog.shape[0],
                             consts.data_ptr(), consts.shape[0], inputs.data_ptr(),
                             tape.n_inputs, tape.n_slots, t_loc.data_ptr(), t_nxt.data_ptr(),
                             nxt_shift % max(n, 1), a_loc.data_ptr(), a_nxt.data_ptr(),
                             nxt_shift % max(n, 1), sel.data_ptr(), out.data_ptr(), n,
                             kernels.stream_of(t_loc)),
        "quotient_tape",
    )
    kernels.count_launch("K5", (tape.width, len(tape.prog), tape.n_slots, n))
    return out
