"""Batched Jacobian-coordinate BN254 point arithmetic on limb tensors.

Port of `plonky2_bn254_tpu/starks/jacobian.py`.  The scalar-mul chains run
in Jacobian coordinates (inversion-free), and all points are normalised to
affine afterwards with one batched inversion.  Coordinates: (X, Y, Z) with
x = X/Z^2, y = Y/Z^3; no point at infinity is representable.  Every linear
combination of residues below lies in [0, 8p), so `reduce_small` gives the
reference's `mod_p(carry_prop(., 32))`.
"""

from __future__ import annotations

from . import bigint
from .bigint import mulmod, reduce_small


def _p(t):
    return bigint.const_row(bigint.MOD_LIMBS_INT, t.device)


def double(X, Y, Z):
    """dbl-2009-l (a=0): one Jacobian doubling, batched."""
    P = _p(X)
    A = mulmod(X, X)
    B = mulmod(Y, Y)
    C = mulmod(B, B)
    XB = reduce_small(X + B)
    D = mulmod(XB, XB)
    D = reduce_small(2 * (D - A - C) + 4 * P)
    E = reduce_small(3 * A)
    F = mulmod(E, E)
    X3 = reduce_small((F - 2 * D) + 2 * P)
    DX3 = reduce_small((D - X3) + P)
    Y3 = mulmod(E, DX3)
    C8 = reduce_small(8 * C)
    Y3 = reduce_small((Y3 - C8) + P)
    YZ = mulmod(Y, Z)
    Z3 = reduce_small(2 * YZ)
    return X3, Y3, Z3


def mixed_add(X1, Y1, Z1, x2, y2):
    """madd-2007-bl: Jacobian + affine -> Jacobian, batched.  The points
    must be distinct and not negatives of each other."""
    P = _p(X1)
    Z1Z1 = mulmod(Z1, Z1)
    U2 = mulmod(x2, Z1Z1)
    S2 = mulmod(mulmod(y2, Z1), Z1Z1)
    H = reduce_small((U2 - X1) + P)
    HH = mulmod(H, H)
    I = reduce_small(4 * HH)
    J = mulmod(H, I)
    r = reduce_small(2 * (S2 - Y1) + 2 * P)
    V = mulmod(X1, I)
    r2 = mulmod(r, r)
    X3 = reduce_small((r2 - J - 2 * V) + 3 * P)
    VX3 = reduce_small((V - X3) + P)
    YJ = mulmod(Y1, J)
    Y3 = reduce_small((mulmod(r, VX3) - 2 * YJ) + 2 * P)
    Z1H = reduce_small(Z1 + H)
    Z3sq = mulmod(Z1H, Z1H)
    Z3 = reduce_small((Z3sq - Z1Z1 - HH) + 2 * P)
    return X3, Y3, Z3


def to_affine(X, Y, Z):
    """Batched normalisation: one Fermat inversion over the whole batch."""
    z_inv = bigint.batch_inv_mod_p(Z)
    z_inv2 = mulmod(z_inv, z_inv)
    z_inv3 = mulmod(z_inv2, z_inv)
    return mulmod(X, z_inv2), mulmod(Y, z_inv3)
