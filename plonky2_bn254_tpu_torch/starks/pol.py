"""Limb-polynomial helpers, generic over the value ring.

Port of `plonky2_bn254_tpu/starks/pol.py`.  Polynomials are python lists of
values supporting `+`, `-`, `*`: int64 tensors (trace generation), `air.GL`
wrappers (prover constraint evaluation) or `extension.GLExt` scalars
(verifier at zeta).
"""

from __future__ import annotations

import torch


def _mul_small(v, c: int):
    """Multiply a ring value by a small python-int constant."""
    if hasattr(v, "scalar_mul"):
        return v.scalar_mul(c)
    return v * c


def pol_add(a, b):
    """a + b elementwise; result length max(len) (pads with other's items)."""
    n = max(len(a), len(b))
    out = []
    for i in range(n):
        if i < len(a) and i < len(b):
            out.append(a[i] + b[i])
        elif i < len(a):
            out.append(a[i])
        else:
            out.append(b[i])
    return out


def pol_sub(a, b):
    """a - b; requires len(a) >= len(b)."""
    assert len(a) >= len(b)
    return [a[i] - b[i] if i < len(b) else a[i] for i in range(len(a))]


def pol_mul_wide(a, b):
    """Schoolbook product: len(a)+len(b)-1 coefficients.  GL-ring inputs
    take a stacked tensor path; scalar rings keep the generic loop."""
    from .air import GL

    if isinstance(a[0], GL) and isinstance(b[0], GL):
        return _pol_mul_wide_stacked(a, b)
    n_out = len(a) + len(b) - 1
    out = [None] * n_out
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            t = ai * bj
            k = i + j
            out[k] = t if out[k] is None else out[k] + t
    return out


def _pol_mul_wide_stacked(a, b):
    from ..field import goldilocks as gl
    from .air import GL

    na, nb = len(a), len(b)
    B = torch.stack([x.v for x in b])  # [nb, ...]
    out = torch.zeros((na + nb - 1,) + B.shape[1:], dtype=torch.int64, device=B.device)
    for i in range(na):
        out[i : i + nb] = gl.add(out[i : i + nb], gl.mul(a[i].v, B))
    return [GL(out[k]) for k in range(na + nb - 1)]


def pol_mul_scalar(a, c):
    """Multiply every coefficient by a ring value or small int `c`."""
    if isinstance(c, int):
        return [_mul_small(x, c) for x in a]
    return [x * c for x in a]


def pol_adjoin_root(a, root):
    """(x - root) * a(x), same length as a (top coeff of a must be 0).

    res[0] = -root*a[0]; res[i] = a[i-1] - root*a[i].
    """
    out = [_neg(root * a[0])]
    for i in range(1, len(a)):
        out.append(a[i - 1] - root * a[i])
    return out


def _neg(v):
    if hasattr(v, "neg"):
        return v.neg()
    return -v


def pol_remove_root_2exp(a, exp: int):
    """Exact division by (x - 2^exp) on INTEGER coefficient lists.

    q[0] = -(a[0] >> exp); q[i] = (q[i-1] - a[i]) >> exp; last element 0.
    """
    n = len(a)
    q = [None] * n
    q[0] = -(a[0] >> exp)
    for i in range(1, n - 1):
        q[i] = (q[i - 1] - a[i]) >> exp
    q[n - 1] = a[0] - a[0]  # zero of matching type
    return q
