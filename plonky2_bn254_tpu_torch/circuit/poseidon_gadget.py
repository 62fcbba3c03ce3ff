"""In-circuit Poseidon permutation + recursive challenger.

Copy of `plonky2_bn254_tpu/circuit/poseidon_gadget.py`: host Python on ints, which
records the same targets and constraints as the original (tests/test_torch_recursion.py
holds the two packages' circuits equal).

The reference gets these from plonky2 (`PoseidonHash` gates +
`RecursiveChallenger`, used by the recursive STARK verifier at
the reference crate's src/starks/common/verifier.rs:101-185 and by
hash_to_fq2_circuit at the reference crate's src/utils/hash_to_g2.rs:89-107).

A permutation is recorded as one first-class Poseidon op (12 input and 12
output wires) plus one native witness generator; the outer proof constrains
it in its Poseidon-round region (circuit/outer.py).
"""

from __future__ import annotations

from typing import List

from ..field.poseidon_constants import DIGEST_LEN, SPONGE_RATE, WIDTH
from .builder import CircuitBuilder, Generator, Target


def permute_indices(builder: CircuitBuilder, state: List[int]) -> List[int]:
    """Constrained Poseidon permutation over target indices.

    Recorded as ONE first-class poseidon op (12 in wires, 12 out wires)
    plus one native witness generator.  The constraint lives in the outer
    proof's dedicated Poseidon-round region (circuit/outer.py: 32 trace
    rows per permutation, transition constraints over round-boundary
    states — the plonky2 PoseidonGate analog, replacing the ~500
    universal-gate rows per permutation that made recursion-scale outer
    traces infeasible) and in Circuit.check's native replay."""
    assert len(state) == WIDTH
    base = builder.reserve_indices(WIDTH)
    outs = list(range(base, base + WIDTH))
    in_indices = list(state)
    builder.poseidon_ops.append((in_indices, outs))

    def run(w, in_indices=in_indices, outs=outs):
        from ..field.poseidon import h_permute

        v = h_permute([w[i] for i in in_indices])
        return dict(zip(outs, v))

    builder.add_generator(
        Generator(in_indices, outs, run, "poseidon_permute")
    )
    return outs


def permute_targets(builder: CircuitBuilder, state: List[Target]) -> List[Target]:
    """Constrained Poseidon permutation; returns the 12 output targets."""
    out = permute_indices(builder, [t.index for t in state])
    return [Target(i) for i in out]


def hash_no_pad_targets(builder: CircuitBuilder, inputs: List[Target]) -> List[Target]:
    """In-circuit sponge hash (plonky2 hash_n_to_m_no_pad shape): rate-8
    overwrite absorption, zero capacity; returns the 4-target digest."""
    zero = builder.zero()
    state = [zero] * WIDTH
    for start in range(0, len(inputs), SPONGE_RATE):
        chunk = list(inputs[start : start + SPONGE_RATE])
        chunk += [zero] * (SPONGE_RATE - len(chunk))
        state = chunk + state[SPONGE_RATE:]
        state = permute_targets(builder, state)
    return state[:DIGEST_LEN]


def two_to_one_targets(
    builder: CircuitBuilder, left: List[Target], right: List[Target]
) -> List[Target]:
    """In-circuit Merkle two-to-one compression."""
    zero = builder.zero()
    state = list(left) + list(right) + [zero] * (WIDTH - 2 * DIGEST_LEN)
    return permute_targets(builder, state)[:DIGEST_LEN]


class RecursiveChallenger:
    """In-circuit duplex sponge mirroring prover.challenger.Challenger."""

    def __init__(self, builder: CircuitBuilder):
        self.builder = builder
        self.state = [builder.zero() for _ in range(WIDTH)]
        self.input_buffer: List[Target] = []
        self.output_buffer: List[Target] = []

    def observe_element(self, t: Target):
        self.output_buffer = []
        self.input_buffer.append(t)
        if len(self.input_buffer) == SPONGE_RATE:
            self._duplex()

    def observe_elements(self, targets: List[Target]):
        for t in targets:
            self.observe_element(t)

    def observe_cap(self, cap_targets):
        """cap_targets: iterable of 4-target digests."""
        for digest in cap_targets:
            self.observe_elements(list(digest))

    def observe_extension(self, x):
        """x: ExtTarget (circuit.ext_target)."""
        self.observe_elements([x.c0, x.c1])

    def get_challenge(self) -> Target:
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop()

    def get_n_challenges(self, n: int) -> List[Target]:
        return [self.get_challenge() for _ in range(n)]

    def get_extension_challenge(self):
        from .ext_target import ExtTarget

        c0 = self.get_challenge()
        c1 = self.get_challenge()
        return ExtTarget(c0, c1)

    def _duplex(self):
        for i, t in enumerate(self.input_buffer[:SPONGE_RATE]):
            self.state[i] = t
        self.input_buffer = self.input_buffer[SPONGE_RATE:]
        self.state = permute_targets(self.builder, self.state)
        self.output_buffer = list(self.state[:SPONGE_RATE])
        if self.input_buffer:
            self._duplex()
