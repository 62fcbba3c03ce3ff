"""Constraint-evaluation algebra: one AIR definition, many consumers.

Port of `plonky2_bn254_tpu/starks/air.py`.  An eval function is written
against ring VALUES and a `ConstraintConsumer`; instantiations:

  * `GL` — Goldilocks int64 tensors over the LDE coset (prover quotient);
  * `extension.GLExt` — scalar GF(p^2) values at zeta (native verifier).

The consumer alpha-combines every-row, transition, first-row and last-row
constraints into one accumulator per challenge.
"""

from __future__ import annotations

import torch

from ..field import goldilocks as gl
from ..prover.constraints import tree_reduce0


class GL:
    """Ring wrapper for Goldilocks int64 tensors (operator syntax)."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __add__(self, o):
        return GL(gl.add(self.v, o.v))

    def __sub__(self, o):
        return GL(gl.sub(self.v, o.v))

    def __mul__(self, o):
        return GL(gl.mul(self.v, o.v))

    def neg(self):
        return GL(gl.neg(self.v))

    def scalar_mul(self, c: int):
        return GL(gl.mul_const(self.v, c))


class GLRing:
    """Ring factory for `GL` values, batched over a fixed shape and device."""

    def __init__(self, shape=(), device=None):
        self.shape = shape
        self.device = device

    def const(self, x) -> GL:
        if isinstance(x, torch.Tensor):
            return GL(x.to(self.device).expand(self.shape))
        return GL(torch.full(self.shape, gl.i64(int(x) % gl.P), dtype=torch.int64,
                             device=self.device))

    def zero(self) -> GL:
        return self.const(0)

    def one(self) -> GL:
        return self.const(1)

    def wrap(self, arr) -> GL:
        return GL(arr)


class HostExtRing:
    """Ring factory for scalar GLExt values (verifier at zeta)."""

    def const(self, x: int):
        from ..field.extension import GLExt

        return GLExt(x % gl.P)

    def zero(self):
        return self.const(0)

    def one(self):
        return self.const(1)

    def wrap(self, v):
        return v


class ConstraintConsumer:
    """Alpha-combines constraints with starky's row-domain semantics.

    `z_last`, `l_first`, `l_last` are ring values (evaluations of
    (x - g^{n-1}), L_0(x), L_{n-1}(x)); `alphas` is a list of ring values.

    `alpha_pows` (optional, GL ring only): [num_challenges, K] int64 tensor
    of alpha powers, so that `constraint_many` folds a whole group of
    constraints with one weighted mod-sum (Horner identity).
    """

    def __init__(self, ring, alphas, z_last, l_first, l_last, alpha_pows=None):
        self.ring = ring
        self.alphas = alphas
        self.z_last = z_last
        self.l_first = l_first
        self.l_last = l_last
        self.alpha_pows = alpha_pows
        self.accs = [ring.zero() for _ in alphas]
        self.count = 0

    def _accumulate(self, term):
        self.accs = [acc * alpha + term for acc, alpha in zip(self.accs, self.alphas)]
        self.count += 1

    def constraint(self, c):
        """Must vanish on every row."""
        self._accumulate(c)

    def constraint_many(self, items):
        """Fold a group of every-row constraints, equivalent to calling
        `constraint` on each in order."""
        items = list(items)
        if not items:
            return
        if self.alpha_pows is None or not isinstance(items[0], GL):
            for c in items:
                self.constraint(c)
            return
        self.constraint_many_arr(torch.stack([c.v for c in items]))

    def constraint_many_arr(self, stacked):
        """Fold an already-stacked [k, rows] constraint group:
        acc * alpha^k + sum_j alpha^(k-1-j) c_j."""
        k = stacked.shape[0]
        if k == 0:
            return
        for i in range(len(self.accs)):
            w = self.alpha_pows[i, :k].flip(0)
            term = tree_reduce0(gl.mul(stacked, w[:, None]))
            alpha_k = self.ring.const(self.alpha_pows[i, k])
            self.accs[i] = self.accs[i] * alpha_k + GL(term)
        self.count += k

    def constraint_transition(self, c):
        """Must vanish on every row but the last."""
        self._accumulate(c * self.z_last)

    def constraint_first_row(self, c):
        self._accumulate(c * self.l_first)

    def constraint_last_row(self, c):
        self._accumulate(c * self.l_last)


def eval_eq(consumer, filt, a, b):
    """filter * (a - b) = 0; a/b are values or equal-length lists of values."""
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        if isinstance(a[0], GL) and getattr(consumer, "alpha_pows", None) is not None:
            A = torch.stack([x.v for x in a])
            B = torch.stack([y.v for y in b])
            consumer.constraint_many_arr(gl.mul(filt.v[None], gl.sub(A, B)))
        else:
            consumer.constraint_many([filt * (x - y) for x, y in zip(a, b)])
    else:
        consumer.constraint(filt * (a - b))
