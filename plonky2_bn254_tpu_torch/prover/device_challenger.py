"""Fiat–Shamir challenger on a device state: the duplex sponge on tensors.

Port of `plonky2_bn254_tpu/prover/device_challenger.py`.  The host
`Challenger` (challenger.py) makes the prover pull every Merkle cap to
absorb it and hand every challenge back to the device.  This one runs the
same duplex schedule (plonky2 semantics: absorbs buffer up to the rate, then
permute; any absorb invalidates pending outputs) on an int64 `[12]` state
tensor on the proof's device, so challenges stay there, the stages follow
one another on the device's queue, and the proof is pulled once at the end.

As the reference compiles each transcript transition to one executable,
each transition here is one launch of K2t (`poseidon_cuda.sponge_transition`,
its plain version for a CPU tensor): absorbs only queue device vectors and
python ints, and a squeeze, or a read of `.state`, runs everything queued
and the squeezes in that one launch.  The buffer fill levels are python ints
kept here (`counts`); the words absorbed since the last permutation stay on
the device, and the pending outputs are the state's first words.  Tensors
queued for absorbing must not be written before the next squeeze: the
launch raises if one was (its version counter moved).

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
from ..field import inv_cuda
from ..field import poseidon_cuda
from ..field.poseidon_constants import WIDTH
from ..interop import tensor_from_u64
from .constraints import tree_reduce0


class DeviceChallenger:
    """The duplex sponge with its state on `device`."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._state = torch.zeros(WIDTH, dtype=torch.int64, device=self.device)
        self._pending = None  # [n_pending] words absorbed since the last permutation
        self._n_pending = 0
        self._n_out = 0  # pending outputs: state[:n_out], popped from the end
        self._queue: List = []  # 1-D tensors and lists of python ints, in absorb order
        self._versions: List = []  # (queued tensor, its version when queued)
        self._n_queued = 0

    @property
    def state(self) -> torch.Tensor:
        """The [12] state after the last permutation, everything queued
        absorbed first (the proof-of-work grind hashes from it)."""
        if self._queue:
            self._transition(0)
        return self._state

    def counts(self) -> tuple:
        """(input words buffered, outputs pending), as the host challenger's
        buffer lengths."""
        n = self._n_pending + self._n_queued
        if not self._n_queued:
            return n, self._n_out
        return poseidon_cuda.sponge_schedule(n, self._n_out, 0)[1:3]

    # -- absorbing ---------------------------------------------------------

    def observe_element(self, x):
        """x: a canonical field element, python int or 0-d tensor."""
        if isinstance(x, torch.Tensor):
            self._push(x.reshape(1))
        else:
            self._push(int(x))

    def observe_flat(self, xs: torch.Tensor):
        """Absorb a 1-D tensor (an empty one changes nothing)."""
        xs = xs.reshape(-1)
        if xs.shape[0]:
            self._push(xs.contiguous())

    def observe_cap(self, cap: torch.Tensor):
        """cap: [k, 4] digest rows."""
        self.observe_flat(cap.reshape(-1))

    def _push(self, item):
        ints = not isinstance(item, torch.Tensor)
        n_imm = sum(len(q) for q in self._queue if isinstance(q, list))
        segments = len(self._queue) + (self._pending is not None)
        join = ints and self._queue and isinstance(self._queue[-1], list)
        if (segments + (not join) > poseidon_cuda.MAX_SEGMENTS
                or n_imm + ints > poseidon_cuda.MAX_IMMEDIATE):
            self._transition(0)  # one launch takes this many; absorb what is queued
            join = False
        if join:
            self._queue[-1].append(item)
        else:
            self._queue.append([item] if ints else item)
        if not ints:
            self._versions.append((item, item._version))
        self._n_queued += 1 if ints else int(item.shape[0])

    # -- squeezing ---------------------------------------------------------

    def get_challenge(self) -> torch.Tensor:
        return self.get_n_challenges(1)[0]

    def get_n_challenges(self, n: int) -> torch.Tensor:
        """n challenges as one [n] tensor, in squeeze order."""
        if self._queue or self._n_pending or self._n_out < n:
            return self._transition(n)
        out = self._state[self._n_out - n : self._n_out].flip(0)
        self._n_out -= n
        return out

    # -- internals ---------------------------------------------------------

    def _transition(self, n_squeeze: int) -> torch.Tensor:
        """One K2t launch: the pending words and the queue absorbed, then
        `n_squeeze` squeezes."""
        if any(t._version != v for t, v in self._versions):
            raise RuntimeError("DeviceChallenger: a tensor queued for absorbing was written "
                               "before the squeeze that absorbs it")
        vectors = [v for q in self._queue for v in (q if isinstance(q, list) else [q])]
        n_words = self._n_pending + self._n_queued
        state, left, out = poseidon_cuda.sponge_transition(
            self._state, self._pending, vectors, n_squeeze, self._n_out)
        fill, self._n_out = poseidon_cuda.sponge_schedule(n_words, self._n_out, n_squeeze)[1:3]
        self._state = state
        self._pending, self._n_pending = (left, fill) if fill else (None, 0)
        self._queue, self._versions, self._n_queued = [], [], 0
        return out


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
    rows of 1 / (gamma + sum_j beta^j v_j) (`constraints.ctl_total`).  The
    denominators of every (challenge, CTL) pair go into one
    [n_challenges, n_ctls, most rows] tensor, shorter CTLs padded with 1,
    so one batch inversion (one Fermat chain) serves them all; the padding
    is masked out of the sums."""
    dev = betas.device
    nc, n_ctl = betas.shape[0], len(ctl_rows)
    n_rows = [int(r.shape[0]) for r in ctl_rows]
    most_rows = max(n_rows + [1])
    most_cols = max([int(r.shape[1]) for r in ctl_rows] + [1])
    bp = torch.stack([powers_vec(b, most_cols) for b in betas])  # [nc, most_cols]
    dens = torch.ones((nc, n_ctl, most_rows), dtype=torch.int64, device=dev)
    for c, rows in enumerate(ctl_rows):
        if n_rows[c]:
            terms = gl.mul(rows[None], bp[:, None, : rows.shape[1]])  # [nc, rows, cols]
            dens[:, c, : n_rows[c]] = gl.add(tree_reduce0(terms.permute(2, 0, 1)), gammas[:, None])
    live = torch.arange(most_rows)[None, :] < torch.tensor(n_rows, dtype=torch.int64)[:, None]
    inv = torch.where(live.to(dev, non_blocking=True), inv_cuda.batch_inv(dens), 0)
    return tree_reduce0(inv.permute(2, 0, 1))
