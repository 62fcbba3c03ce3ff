"""The row-sharded multi-device prover's layer: a 1-D mesh of
torch.distributed ranks (`mesh`), the all-to-all four-step NTT and coset
LDE over it (`ntt`), and a launcher of SPMD ranks on one host (`launch`)."""

from . import mesh, ntt  # noqa: F401
