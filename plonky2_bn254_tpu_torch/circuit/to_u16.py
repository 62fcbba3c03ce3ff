"""In-circuit 32-bit -> 2x16-bit limb resplit (ToU16).

Copy of `plonky2_bn254_tpu/circuit/to_u16.py`: host Python on ints, which
records the same targets and constraints as the original (tests/test_torch_circuit.py
holds the two packages' circuits equal).

Rebuild of the reference crate's src/generators/to_u16.rs:11-67: the circuit-side
values live as 8x32-bit limbs, the STARK side as 16x16-bit limbs; CTL value
rows are built from the 16-bit halves.  Each split is CONSTRAINED
(lo + 2^16*hi == limb, lo/hi range-checked to 16 bits), so the CTL binding
inherits the circuit wires' values, not generator outputs.
"""

from __future__ import annotations

from typing import List, Tuple

from . import biguint as bu
from .builder import CircuitBuilder, Generator, Target


def split_u32_to_u16(builder: CircuitBuilder, t: Target) -> Tuple[Target, Target]:
    """One 32-bit limb target -> (lo16, hi16) targets (to_u16.rs:16-31)."""
    lo = builder.add_virtual_target()
    hi = builder.add_virtual_target()
    bu.range_check(builder, lo, 16)
    bu.range_check(builder, hi, 16)
    recomposed = builder.add_linear([(1, lo), (1 << 16, hi)])
    builder.connect(recomposed, t)

    def run(w, t=t, lo=lo, hi=hi):
        v = w[t.index]
        return {lo.index: v & 0xFFFF, hi.index: v >> 16}

    builder.add_generator(
        Generator([t.index], [lo.index, hi.index], run, "to_u16")
    )
    return lo, hi


def limbs32_to_u16(
    builder: CircuitBuilder, limbs32: List[Target], n_u16: int = None
) -> List[Target]:
    """Little-endian 32-bit limb targets -> little-endian 16-bit halves,
    zero-padded to `n_u16` (for scalars recorded with < 8 limbs)."""
    out: List[Target] = []
    for t in limbs32:
        lo, hi = split_u32_to_u16(builder, t)
        out.extend([lo, hi])
    if n_u16 is not None:
        assert len(out) <= n_u16
        out.extend([builder.zero()] * (n_u16 - len(out)))
    return out


def fq_to_u16(builder: CircuitBuilder, fq) -> List[Target]:
    return limbs32_to_u16(builder, fq.value.limbs, 16)


def fq2_to_u16(builder: CircuitBuilder, fq2) -> List[Target]:
    return fq_to_u16(builder, fq2.c0) + fq_to_u16(builder, fq2.c1)


def g1_to_u16(builder: CircuitBuilder, pt) -> List[Target]:
    return fq_to_u16(builder, pt.x) + fq_to_u16(builder, pt.y)


def g2_to_u16(builder: CircuitBuilder, pt) -> List[Target]:
    return fq2_to_u16(builder, pt.x) + fq2_to_u16(builder, pt.y)
