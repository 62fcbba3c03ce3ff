"""BN254 base field and G1 on python ints (y^2 = x^3 + 3; None is infinity)."""

from __future__ import annotations

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
B_G1 = 3


def on_curve(pt) -> bool:
    x, y = pt
    return (y * y - x * x * x - B_G1) % P == 0


def g1_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    (x1, y1), (x2, y2) = a, b
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return x3, (lam * (x1 - x3) - y1) % P


def g1_mul(pt, k: int):
    acc, add = None, pt
    while k:
        if k & 1:
            acc = g1_add(acc, add)
        add = g1_add(add, add)
        k >>= 1
    return acc


def sqrt(a: int):
    """A square root of a mod P (P = 3 mod 4), or None if a is no square."""
    r = pow(a, (P + 1) // 4, P)
    return r if r * r % P == a % P else None
