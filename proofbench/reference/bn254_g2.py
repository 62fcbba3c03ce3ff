"""BN254's G2 on python ints: Fq2 = Fq[u]/(u^2 + 1) and the twist
y^2 = x^3 + 3 / (9 + u).

An Fq2 element is a pair (c0, c1) for c0 + c1 u; an affine point is
((x0, x1), (y0, y1)) and None is infinity.  Scalar multiplication runs in
Jacobian coordinates (x = X / Z^2, y = Y / Z^3) and inverts once at the
end.  The generator and the group order are EIP-197's.
"""

from __future__ import annotations

from .bn254 import P

R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
GENERATOR = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)
ZERO, ONE = (0, 0), (1, 0)


def f2_add(a, b):
    return (a[0] + b[0]) % P, (a[1] + b[1]) % P


def f2_sub(a, b):
    return (a[0] - b[0]) % P, (a[1] - b[1]) % P


def f2_mul(a, b):
    t0, t1 = a[0] * b[0], a[1] * b[1]
    return (t0 - t1) % P, ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % P


def f2_sqr(a):
    return (a[0] + a[1]) * (a[0] - a[1]) % P, 2 * a[0] * a[1] % P


def f2_scale(a, k: int):
    return a[0] * k % P, a[1] * k % P


def f2_inv(a):
    n = pow((a[0] * a[0] + a[1] * a[1]) % P, -1, P)
    return a[0] * n % P, -a[1] * n % P


B_G2 = f2_scale(f2_inv((9, 1)), 3)


def on_twist(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return f2_sqr(y) == f2_add(f2_mul(f2_sqr(x), x), B_G2)


# -- Jacobian coordinates; Z = 0 is infinity ----------------------------------

INFINITY = (ONE, ONE, ZERO)


def jac_double(pt):
    """dbl-2009-l (a = 0)."""
    X, Y, Z = pt
    if Z == ZERO:
        return pt
    A, B = f2_sqr(X), f2_sqr(Y)
    C = f2_sqr(B)
    D = f2_scale(f2_sub(f2_sub(f2_sqr(f2_add(X, B)), A), C), 2)
    E = f2_scale(A, 3)
    X3 = f2_sub(f2_sqr(E), f2_scale(D, 2))
    Y3 = f2_sub(f2_mul(E, f2_sub(D, X3)), f2_scale(C, 8))
    return X3, Y3, f2_scale(f2_mul(Y, Z), 2)


def jac_add_affine(pt, q):
    """pt + q for an affine q: H = x2 Z^2 - X, r = y2 Z^3 - Y,
    X3 = r^2 - H^3 - 2 X H^2, Y3 = r (X H^2 - X3) - Y H^3, Z3 = Z H."""
    if q is None:
        return pt
    X, Y, Z = pt
    if Z == ZERO:
        return q[0], q[1], ONE
    ZZ = f2_sqr(Z)
    H = f2_sub(f2_mul(q[0], ZZ), X)
    r = f2_sub(f2_mul(q[1], f2_mul(Z, ZZ)), Y)
    if H == ZERO:
        return jac_double(pt) if r == ZERO else INFINITY
    HH = f2_sqr(H)
    HHH, V = f2_mul(H, HH), f2_mul(X, HH)
    X3 = f2_sub(f2_sub(f2_sqr(r), HHH), f2_scale(V, 2))
    Y3 = f2_sub(f2_mul(r, f2_sub(V, X3)), f2_mul(Y, HHH))
    return X3, Y3, f2_mul(Z, H)


def to_affine(pt):
    X, Y, Z = pt
    if Z == ZERO:
        return None
    zi = f2_inv(Z)
    zi2 = f2_sqr(zi)
    return f2_mul(X, zi2), f2_mul(Y, f2_mul(zi2, zi))


def jac_mul(pt, k: int):
    """k pt for an affine pt, as a Jacobian point (left to right)."""
    acc = INFINITY
    for bit in bin(k)[2:]:
        acc = jac_double(acc)
        if bit == "1":
            acc = jac_add_affine(acc, pt)
    return acc


def g2_add(a, b):
    if a is None:
        return b
    return to_affine(jac_add_affine((a[0], a[1], ONE), b))


def g2_mul(pt, k: int):
    return to_affine(jac_mul(pt, k))


def g2_mul_add(pt, k: int, offset):
    """k pt + offset, with one inversion."""
    return to_affine(jac_add_affine(jac_mul(pt, k), offset))
