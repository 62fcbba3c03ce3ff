"""A uniform point of G1 (cofactor 1): a random x with a square x^3 + 3,
and either root."""

from reference import bn254

from . import fq


def draw(g, spec=None) -> tuple:
    while True:
        x = fq.draw(g)
        y = bn254.sqrt((x * x * x + bn254.B_G1) % bn254.P)
        if y is not None:
            return x, (bn254.P - y) % bn254.P if g.integers(0, 2) else y
