"""Fiat–Shamir challenger on a device state: the duplex sponge on tensors.

Port of `plonky2_bn254_tpu/prover/device_challenger.py`.  The host
`Challenger` (challenger.py) makes the prover pull every Merkle cap to
absorb it and hand every challenge back to the device.  This one runs the
same duplex schedule (plonky2 semantics: absorbs buffer up to the rate, then
permute; any absorb invalidates pending outputs) on an int64 `[12]` state
tensor on the proof's device, so challenges stay there, the stages follow
one another on the device's queue, and the proof is pulled once at the end.
Buffer fill levels are python ints; buffered values are 0-d tensors.

Each duplex is one permutation of a `[1, 12]` state through K2
(`field/poseidon_cuda.permute_states`), which takes its plain version for a
CPU tensor, as every wrapper does.  A full-rate chunk of `observe_flat` is
one permutation, as in the reference.

Where the reference differs from the host challenger, this module follows
the host: absorbing an empty vector changes nothing (the reference clears
the pending outputs, `device_challenger.py:66`), and `ctl_rows_device`
zero-pads CTL rows of different lengths to the longest (the reference's
`np.array(rows)` fails on them); a zero value adds nothing to
`gamma + sum_j beta^j v_j`, so the totals equal `constraints.ctl_total`.

The reference's `pack`/`unpack` and `CountingSponge` carry the buffers
across jit boundaries with static shapes; the port runs eagerly with one
challenger object through the proof and has neither.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..field import goldilocks as gl
from ..field import poseidon_cuda
from ..field.poseidon_constants import SPONGE_RATE as RATE
from ..field.poseidon_constants import WIDTH
from ..interop import tensor_from_u64
from .constraints import tree_reduce0


def _permute1(state: torch.Tensor) -> torch.Tensor:
    """[12] -> [12]: one state through the batched permutation (K2)."""
    return poseidon_cuda.permute_states(state[None])[0]


class DeviceChallenger:
    """The duplex sponge with its state on `device`."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.state = torch.zeros(WIDTH, dtype=torch.int64, device=self.device)
        self.input_buffer: List[torch.Tensor] = []
        self.output_buffer: List[torch.Tensor] = []

    def _scalar(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.reshape(())
        return torch.full((), gl.i64(int(x)), dtype=torch.int64, device=self.device)

    # -- absorbing ---------------------------------------------------------

    def observe_element(self, x):
        """x: a canonical field element, python int or 0-d tensor."""
        self.output_buffer = []
        self.input_buffer.append(self._scalar(x))
        if len(self.input_buffer) == RATE:
            self._duplex()

    def observe_flat(self, xs: torch.Tensor):
        """Absorb a 1-D tensor: the partial buffer topped up element by
        element, then one permutation per full-rate chunk, then the tail."""
        n = int(xs.shape[0])
        if n == 0:
            return
        self.output_buffer = []
        fill = min((-len(self.input_buffer)) % RATE, n)
        for i in range(fill):
            self.observe_element(xs[i])
        n_chunks = (n - fill) // RATE
        for c in range(n_chunks):
            lo = fill + c * RATE
            self.state = _permute1(torch.cat([xs[lo : lo + RATE], self.state[RATE:]]))
        if n_chunks:
            self.output_buffer = list(self.state[:RATE])
        for i in range(fill + n_chunks * RATE, n):
            self.observe_element(xs[i])

    def observe_cap(self, cap: torch.Tensor):
        """cap: [k, 4] digest rows."""
        self.observe_flat(cap.reshape(-1))

    # -- squeezing ---------------------------------------------------------

    def get_challenge(self) -> torch.Tensor:
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop()

    def get_n_challenges(self, n: int) -> List[torch.Tensor]:
        return [self.get_challenge() for _ in range(n)]

    # -- internals ---------------------------------------------------------

    def _duplex(self):
        k = len(self.input_buffer)
        if k:
            self.state = torch.cat([torch.stack(self.input_buffer), self.state[k:]])
            self.input_buffer = []
        self.state = _permute1(self.state)
        self.output_buffer = list(self.state[:RATE])


# ---------------------------------------------------------------------------
# challenge-derived tables on the device
# ---------------------------------------------------------------------------


def powers_vec(base: torch.Tensor, n: int) -> torch.Tensor:
    """[base^0 .. base^(n-1)] by doubling concatenation (0-d tensor base)."""
    pows = torch.ones(1, dtype=torch.int64, device=base.device)
    cur = base
    while pows.shape[0] < n:
        pows = torch.cat([pows, gl.mul(pows, cur)])
        cur = gl.square(cur)
    return pows[:n]


def ext_powers_rows(c0: torch.Tensor, c1: torch.Tensor, n: int) -> torch.Tensor:
    """[n, 2] rows of (c0 + c1 u)^j, u^2 = 7 (0-d tensor base)."""
    p0 = torch.ones(1, dtype=torch.int64, device=c0.device)
    p1 = torch.zeros(1, dtype=torch.int64, device=c0.device)
    b0, b1 = c0, c1
    while p0.shape[0] < n:
        b1w = gl.mul_const(b1, 7)
        q0 = gl.add(gl.mul(p0, b0), gl.mul(p1, b1w))
        q1 = gl.add(gl.mul(p0, b1), gl.mul(p1, b0))
        p0 = torch.cat([p0, q0])
        p1 = torch.cat([p1, q1])
        # (b0 + b1 u)^2 = b0^2 + 7 b1^2 + 2 b0 b1 u
        b0, b1 = (gl.add(gl.square(b0), gl.mul_const(gl.square(b1), 7)),
                  gl.mul_const(gl.mul(b0, b1), 2))
    return torch.stack([p0[:n], p1[:n]], dim=1)


def ctl_weights_device(stark, beta: torch.Tensor) -> List[torch.Tensor]:
    """Per CTL, the weight of each flat column slot, beta^k * 2^j (the
    device twin of `CtlSpec.flat_weights`; the column indices are static
    and the caller takes them from `flat_weights`)."""
    out = []
    for ctl in stark.ctls:
        ks, mults = [], []
        for k, (kind, spec) in enumerate([(c[0], c[1]) for c in ctl.columns]):
            if kind == "single":
                ks.append(k)
                mults.append(1)
            else:
                for j, _ in enumerate(spec):
                    ks.append(k)
                    mults.append((1 << j) % gl.P)
        bp = powers_vec(beta, len(ctl.columns))
        idx = torch.tensor(ks, dtype=torch.int64).to(beta.device, non_blocking=True)
        out.append(gl.mul(bp[idx], tensor_from_u64(np.array(mults, dtype=np.uint64),
                                                   beta.device)))
    return out


def ctl_rows_device(rows, device) -> torch.Tensor:
    """One CTL's value rows as an [n_rows, max_len] tensor, shorter rows
    zero-padded to the longest (at least one column)."""
    width = max([len(r) for r in rows] + [1])
    arr = np.zeros((len(rows), width), dtype=np.uint64)
    for i, r in enumerate(rows):
        arr[i, : len(r)] = [int(v) for v in r]
    return tensor_from_u64(arr, device)


def ctl_totals_device(ctl_rows: List[torch.Tensor], betas: torch.Tensor,
                      gammas: torch.Tensor) -> torch.Tensor:
    """[n_challenges, n_ctls] extra looking totals: per CTL the sum over its
    rows of 1 / (gamma + sum_j beta^j v_j) (`constraints.ctl_total`)."""
    totals = torch.zeros((betas.shape[0], len(ctl_rows)), dtype=torch.int64,
                         device=betas.device)
    for i, (beta, gamma) in enumerate(zip(betas, gammas)):
        for c, rows in enumerate(ctl_rows):
            if rows.shape[0]:
                bp = powers_vec(beta, rows.shape[1])
                acc = gl.add(tree_reduce0(gl.mul(rows, bp).T), gamma)
                totals[i, c] = tree_reduce0(gl.batch_inv(acc))
    return totals
