"""fq_mul row semantics: a * b ≡ c (mod p) via mul_wide + modulus_zero.

Port of `plonky2_bn254_tpu/starks/fq_mul.py`: batched generation,
ring-generic evaluation (one definition for prover and verifier).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import bigint, modular, pol
from .limbs import N_LIMBS


def generate_fq_mul(a: torch.Tensor, b: torch.Tensor):
    """Batched: [..., 16] x [..., 16] -> (c [..., 16], ModulusZeroAux)."""
    c = bigint.mulmod(a, b)
    diff = bigint._pol_mul_aa(a, b) - F.pad(c, (0, N_LIMBS - 1))  # [..., 31]
    return c, modular.generate_modulus_zero(diff)


def eval_fq_mul(consumer, ring, filt, modulus, a, b, c, aux):
    """Ring-generic mirror of eval_fq_mul."""
    ab = pol.pol_mul_wide(a, b)  # 31 values
    diff = [ab[i] - c[i] if i < N_LIMBS else ab[i] for i in range(2 * N_LIMBS - 1)]
    modular.eval_modulus_zero(consumer, ring, filt, modulus, diff, aux)
