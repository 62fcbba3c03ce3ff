"""Host-side BN254 ground-truth arithmetic over python ints.

Copy of the Fq and G1 parts of `plonky2_bn254_tpu/bn254/oracle.py` (pinned
to the original by tests/test_torch_isolation.py): the inputs and output
checks of the G1 scalar-mul machine.  Fq elements are python ints in
[0, P); affine points are (x, y) tuples with `None` for infinity.
"""

from __future__ import annotations

from . import params

P = params.P


# ---------------------------------------------------------------------------
# Fq
# ---------------------------------------------------------------------------


def fq_inv(x: int) -> int:
    """Zero-returning inverse (matches reference `Inv` convention)."""
    return pow(x % P, P - 2, P) if x % P else 0


def fq_sgn(x: int) -> bool:
    """RFC-9380 sgn0 for Fq: parity of the canonical representative."""
    return bool(x % P & 1)


def fq_is_square(x: int) -> bool:
    x %= P
    return x == 0 or pow(x, (P - 1) // 2, P) == 1


def fq_sqrt(x: int):
    """A square root of x mod P, or None (P % 4 == 3 -> simple formula)."""
    x %= P
    assert P % 4 == 3
    r = pow(x, (P + 1) // 4, P)
    return r if r * r % P == x else None


# ---------------------------------------------------------------------------
# G1: y^2 = x^3 + 3 over Fq  (affine; None = infinity)
# ---------------------------------------------------------------------------


def g1_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - params.B_G1) % P == 0


def g1_neg(pt):
    if pt is None:
        return None
    return (pt[0], -pt[1] % P)


def g1_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 * fq_inv(2 * y1 % P) % P
    else:
        lam = (y2 - y1) * fq_inv((x2 - x1) % P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def g1_mul(pt, k: int):
    acc = None
    add = pt
    while k > 0:
        if k & 1:
            acc = g1_add(acc, add)
        add = g1_add(add, add)
        k >>= 1
    return acc


# ---------------------------------------------------------------------------
# Random sampling (for tests and blinding generators)
# ---------------------------------------------------------------------------


def random_fq(rng) -> int:
    return int(rng.integers(0, 1 << 63)) * int(rng.integers(0, 1 << 63)) * 7 % P


def random_g1(rng):
    """Random G1 point by hashing to x and recovering y (cofactor 1)."""
    while True:
        x = random_fq(rng)
        rhs = (x * x * x + params.B_G1) % P
        if fq_is_square(rhs):
            y = fq_sqrt(rhs)
            if int(rng.integers(0, 2)):
                y = -y % P
            return (x, y)
