"""A uniform element of the BN254 base field (bias below 2^-60)."""

from reference import bn254


def draw(g, spec=None) -> int:
    return int.from_bytes(g.bytes(40), "little") % bn254.P
