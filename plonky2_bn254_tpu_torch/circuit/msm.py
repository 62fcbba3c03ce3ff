"""G1 multi-scalar multiplication gadget.

Copy of `plonky2_bn254_tpu/circuit/msm.py`: host Python on ints, which
records the same targets and constraints as the original (tests/test_torch_circuit.py
holds the two packages' circuits equal).

Rebuild of the reference crate's src/utils/g1_msm.rs:22-36: MSM as a fold of
`g1_scalar_mul` chained through a random checked offset (blinding keeps
every intermediate sum off infinity), subtracted once at the end.
"""

from __future__ import annotations

from typing import List

from . import builder_ops
from .builder import CircuitBuilder
from .curves import G1Target


def g1_msm(builder: CircuitBuilder, scalars: List, points: List[G1Target]) -> G1Target:
    assert len(scalars) == len(points) and len(points) > 0
    offset = G1Target.new_checked(builder)
    builder_ops.set_random_g1(builder, offset)
    acc = offset
    for s, p in zip(scalars, points):
        acc = builder_ops.g1_scalar_mul(builder, s, p, acc)
    neg_offset = offset.neg(builder)
    return acc.add(builder, neg_offset)
