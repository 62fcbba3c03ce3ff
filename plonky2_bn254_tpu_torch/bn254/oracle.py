"""Host-side BN254 ground-truth arithmetic over python ints.

Copy of the Fq, Fq2, G1 and G2 parts of `plonky2_bn254_tpu/bn254/oracle.py`
(pinned to the original by tests/test_torch_isolation.py): the inputs and
output checks of the scalar-mul and exponentiation machines.  Fq elements
are python ints in [0, P), Fq2 elements (c0, c1) pairs of them; affine
points are (x, y) tuples with `None` for infinity.
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
# Fq2 = Fq[u]/(u^2 + 1)
# ---------------------------------------------------------------------------


def fq2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fq2_neg(a):
    return (-a[0] % P, -a[1] % P)


def fq2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u), u^2 = -1
    return (
        (a[0] * b[0] - a[1] * b[1]) % P,
        (a[0] * b[1] + a[1] * b[0]) % P,
    )


def fq2_mul_scalar(a, s: int):
    return (a[0] * s % P, a[1] * s % P)


def fq2_inv(a):
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    if norm == 0:
        return (0, 0)
    ninv = fq_inv(norm)
    return (a[0] * ninv % P, -a[1] * ninv % P)


def fq2_sgn(a) -> bool:
    """RFC-9380 sgn0 over Fq2 (reference src/fields/fq2.rs sgn rule):
    sgn(c0) if c0 != 0 else sgn(c1)."""
    sgn0 = a[0] & 1
    zero0 = a[0] % P == 0
    sgn1 = a[1] & 1
    return bool(sgn0 or (zero0 and sgn1))


def fq2_is_square(a) -> bool:
    # a is a square in Fq2 iff its norm c0^2 + c1^2 is a square in Fq
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    return fq_is_square(norm)


def fq2_sqrt(a):
    """Square root in Fq2 via the norm trick; None if not a square."""
    c0, c1 = a[0] % P, a[1] % P
    if c1 == 0:
        if fq_is_square(c0):
            return (fq_sqrt(c0), 0)
        # sqrt(c0) = sqrt(-c0) * u since u^2 = -1
        r = fq_sqrt(-c0 % P)
        assert r is not None
        return (0, r)
    norm = (c0 * c0 + c1 * c1) % P
    if not fq_is_square(norm):
        return None
    alpha = fq_sqrt(norm)
    # want x0^2 = (c0 + alpha)/2 (try both alpha signs)
    for al in (alpha, -alpha % P):
        delta = (c0 + al) * fq_inv(2) % P
        if fq_is_square(delta):
            x0 = fq_sqrt(delta)
            x1 = c1 * fq_inv(2 * x0 % P) % P
            if fq2_mul((x0, x1), (x0, x1)) == (c0, c1):
                return (x0, x1)
    return None

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
# G2: y^2 = x^3 + b2 over Fq2
# ---------------------------------------------------------------------------


def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    b = (params.B_G2_C0, params.B_G2_C1)
    lhs = fq2_mul(y, y)
    rhs = fq2_add(fq2_mul(fq2_mul(x, x), x), b)
    return lhs == rhs


def g2_neg(pt):
    if pt is None:
        return None
    return (pt[0], fq2_neg(pt[1]))


def g2_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if fq2_add(y1, y2) == (0, 0):
            return None
        num = fq2_mul_scalar(fq2_mul(x1, x1), 3)
        lam = fq2_mul(num, fq2_inv(fq2_mul_scalar(y1, 2)))
    else:
        lam = fq2_mul(fq2_sub(y2, y1), fq2_inv(fq2_sub(x2, x1)))
    x3 = fq2_sub(fq2_sub(fq2_mul(lam, lam), x1), x2)
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_mul(pt, k: int):
    acc = None
    add = pt
    while k > 0:
        if k & 1:
            acc = g2_add(acc, add)
        add = g2_add(add, add)
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


def random_g2(rng):
    """Random point in the G2 subgroup (curve point * cofactor)."""
    b = (params.B_G2_C0, params.B_G2_C1)
    while True:
        x = (random_fq(rng), random_fq(rng))
        rhs = fq2_add(fq2_mul(fq2_mul(x, x), x), b)
        if fq2_is_square(rhs):
            y = fq2_sqrt(rhs)
            pt = g2_mul((x, y), params.G2_COFACTOR)
            if pt is not None:
                return pt
