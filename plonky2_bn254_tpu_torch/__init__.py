"""plonky2_bn254_tpu_torch — the PyTorch/CUDA port of plonky2_bn254_tpu.

BN254 elliptic-curve operations proven inside STARKs over the Goldilocks
field, with the same module layout as the JAX package (`field/`, `bn254/`,
`starks/`, `prover/`, `utils/`).  Plain code is PyTorch on int64 tensors
that hold u64 bit patterns; the four kernels of the commit and grind path
(Poseidon leaf sponge, raw permutation, NTT, coset LDE) are hand-written CUDA
for Hopper under `csrc/`, built at first use (`kernels.py`).  The package
imports torch and numpy, never JAX.
"""

__version__ = "0.1.0"
