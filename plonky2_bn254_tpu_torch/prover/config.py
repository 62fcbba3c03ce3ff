"""STARK configuration.

Functional equivalent of the reference's `StarkConfig::standard_fast_config`
(used at e.g. the reference crate's src/generators/g1/stark_proof.rs:85): rate 1/2
LDE, 84 query rounds, 16 bits of proof-of-work, Merkle cap height 4, two
independent challenge rounds — ~100 bits of conjectured security.

FRI folds use arity 2^ARITY_BITS per round down to FINAL_POLY_DEGREE_BITS.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class StarkConfig:
    num_challenges: int = 2
    rate_bits: int = 1
    cap_height: int = 4
    proof_of_work_bits: int = 16
    num_query_rounds: int = 84
    arity_bits: int = 4
    final_poly_degree_bits: int = 5

    @property
    def rate(self) -> int:
        return 1 << self.rate_bits


DEFAULT_CONFIG = StarkConfig()

# Small config for fast CPU tests (fewer queries, shallow cap). NOT secure.
TEST_CONFIG = StarkConfig(
    num_challenges=2,
    rate_bits=1,
    cap_height=1,
    proof_of_work_bits=8,
    num_query_rounds=12,
    arity_bits=2,
    final_poly_degree_bits=3,
)
