"""The device-FS prover on the FqExp machine against the host flow and the
JAX package.

2 FqExp ops (427 columns, two CTLs of 17-limb rows), the shape of
tests/test_fq_exp_trace.py; `prove(device_fs=True)` must equal the port's
host-FS proof field by field (exact integer arithmetic: tolerance zero).
The comparison with the JAX package's device-FS proof, which compiles the
FqExp machine in XLA for minutes, is in the slow tier, at 2048 rows and at
the production 2^16 rows.  On the CPU every duplex takes K2's plain version.
"""

import numpy as np
import pytest
import torch

from plonky2_bn254_tpu.prover import prove as jprove
from plonky2_bn254_tpu.prover import verify as jverify
from plonky2_bn254_tpu.prover.config import TEST_CONFIG as JTEST_CONFIG
from plonky2_bn254_tpu_torch.interop import proof_to_fields
from plonky2_bn254_tpu_torch.prover import prove as prove_mod
from plonky2_bn254_tpu_torch.prover import verify as verify_mod
from plonky2_bn254_tpu_torch.prover.config import TEST_CONFIG
from test_torch_prove import assert_fields_equal

torch.set_num_threads(2)


def _fq_exp_case(min_rows: int):
    from plonky2_bn254_tpu_torch.bn254 import oracle
    from plonky2_bn254_tpu_torch.starks import fq_exp

    rng = np.random.default_rng(9)
    inputs = [(int(rng.integers(1, 1 << 63)) << 190 | t, oracle.random_fq(rng), t)
              for t in range(2)]
    return (inputs, fq_exp.generate_trace(inputs, min_rows=min_rows, device="cpu"),
            fq_exp.generate_ctl_values(inputs))


def test_fq_exp_device_fs_proof_equals_host():
    """2 FqExp ops at 2048 rows (427 columns, two CTLs of 17-limb rows).
    Fewer than 2^16 rows cannot satisfy the range counter, so this compares
    the two flows' proofs only; the JAX comparison is in the slow tier."""
    from plonky2_bn254_tpu_torch.starks.table import fq_exp_stark

    _, trace, ctl = _fq_exp_case(2048)
    dev = prove_mod.prove(fq_exp_stark(), trace, ctl, TEST_CONFIG, device_fs=True)
    host = prove_mod.prove(fq_exp_stark(), trace, ctl, TEST_CONFIG, device_fs=False)
    assert_fields_equal(proof_to_fields(dev), proof_to_fields(host))


@pytest.mark.slow
@pytest.mark.parametrize("min_rows", [2048, 1 << 16])
def test_fq_exp_device_fs_proof_equals_jax(min_rows):
    """2 FqExp ops against the JAX package's device-FS proof, at 2048 rows
    and at the hook's production 2^16 rows (DEFAULT_CONFIG there)."""
    import jax.numpy as jnp

    from plonky2_bn254_tpu.prover.config import DEFAULT_CONFIG as JDEFAULT_CONFIG
    from plonky2_bn254_tpu.starks.table import fq_exp_stark as jfq_exp_stark
    from plonky2_bn254_tpu_torch.prover.config import DEFAULT_CONFIG
    from plonky2_bn254_tpu_torch.starks.table import fq_exp_stark

    config, jconfig = ((TEST_CONFIG, JTEST_CONFIG) if min_rows == 2048
                       else (DEFAULT_CONFIG, JDEFAULT_CONFIG))
    _, trace, ctl = _fq_exp_case(min_rows)
    tproof = prove_mod.prove(fq_exp_stark(), trace, ctl, config, device_fs=True)
    jtrace = jnp.asarray(trace.numpy().view(np.uint64))
    jproof = jprove.prove(jfq_exp_stark(), jtrace, ctl, jconfig, device_fs=True)
    assert_fields_equal(proof_to_fields(tproof), proof_to_fields(jproof))
    if min_rows == 1 << 16:
        verify_mod.verify(fq_exp_stark(), tproof, ctl, config)
        jverify.verify(jfq_exp_stark(), jproof, ctl, jconfig)
