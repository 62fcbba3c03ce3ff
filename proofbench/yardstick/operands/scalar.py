"""A scalar (high << high_shift) | low, high in [1, 2^high_bits), low in
[0, 2^low_bits), with the shift and widths from the traffic mix."""


def draw(g, spec: dict) -> int:
    high = int(g.integers(1, 1 << spec["high_bits"]))
    return high << spec["high_shift"] | int(g.integers(0, 1 << spec["low_bits"]))
