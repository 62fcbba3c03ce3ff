"""A uniform point of G2, BN254's order-r subgroup of the twist: k G for k
uniform in [1, r) (bias below 2^-60).  The subgroup is cyclic, so k G is
uniform in it.

k G is summed in Jacobian coordinates, with one inversion, from a fixed
table of the multiples j 2^(8i) G (j < 256), one a byte of k: 32 additions
a point where the table of the 2^i G alone takes ~127.
"""

from __future__ import annotations

import functools

from reference import bn254_g2 as g2

WINDOW = 8


@functools.lru_cache(maxsize=None)
def table() -> tuple:
    """table[i][j] = j 2^(8i) G, affine (j = 0 is infinity), built once a
    process."""
    rows, base = [], g2.GENERATOR
    for _ in range(-(-g2.R.bit_length() // WINDOW)):
        row = [None, base]
        for _ in range(2, 1 << WINDOW):
            row.append(g2.g2_add(row[-1], base))
        rows.append(tuple(row))
        base = g2.g2_add(row[-1], base)
    return tuple(rows)


def draw(g, spec=None) -> tuple:
    k = int.from_bytes(g.bytes(40), "little") % (g2.R - 1) + 1
    acc = g2.INFINITY
    for i, row in enumerate(table()):
        acc = g2.jac_add_affine(acc, row[k >> (WINDOW * i) & ((1 << WINDOW) - 1)])
    return g2.to_affine(acc)
