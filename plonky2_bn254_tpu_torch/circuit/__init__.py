"""Circuit gadget layer: the reference's L7-L9 public API surface.

Port of `plonky2_bn254_tpu/circuit/`.  The gadget
layer is host Python on ints; the hook's batch provers and the outer prover
run on the card unless the caller passes `device="cpu"`.

  builder.py       — CircuitBuilder / targets / generators / hooks (L0 analog)
  biguint.py       — BigUintTarget + CircuitBuilderBiguint ops (fields/biguint.rs)
  fq.py, fq2.py    — FqTarget / Fq2Target gadgets (fields/fq.rs, fq2.rs)
  curves.py        — G1Target / G2Target (curves/g1.rs, g2.rs)
  builder_ops.py   — fq_exp / g1_scalar_mul / g2_scalar_mul + Bn254Hook
                     (builder.rs, hook.rs, generators/)
  msm.py           — g1_msm (utils/g1_msm.rs)
  hash_to_g2.py    — HashToG2 (utils/hash_to_g2.rs)
  poseidon_gadget.py — in-circuit Poseidon + RecursiveChallenger
  ext_target.py    — degree-2 extension targets, bit split, random access
  stark_verifier.py — the recursive STARK verifier over targets
  outer.py         — the universal-gate outer STARK: compile, prove, verify
"""

from .builder import CircuitBuilder, Circuit, Target, Witness  # noqa: F401
from .biguint import (  # noqa: F401
    BigUintTarget,
    add_biguint,
    add_virtual_biguint_target,
    cmp_biguint,
    constant_biguint,
    div_rem_biguint,
    mul_biguint,
    sub_biguint,
)
from .fq import FqTarget  # noqa: F401
from .fq2 import Fq2Target  # noqa: F401
from .curves import G1Target, G2Target  # noqa: F401
from .builder_ops import (  # noqa: F401
    fq_exp,
    g1_scalar_mul,
    g2_scalar_mul,
    get_bn254_hook,
    set_random_g1,
    set_random_g2,
)
from .msm import g1_msm  # noqa: F401
from . import hash_to_g2  # noqa: F401
