"""The port's twin of tests/test_micro_starks.py: the mod-zero and G1-add
micro machines (64 rows, no LogUp lookup, I/O bound through one CTL, where
CTL bookkeeping regressions hide) through the port's prover with both
Fiat–Shamir transcripts.

The same inputs (numpy seed) give the port's trace and the JAX package's;
the traces are equal, the port's host-FS and device-FS proofs are equal to
each other and to the JAX proof field by field (exact integer arithmetic:
tolerance zero), the port's verifier accepts them and rejects other claimed
CTL values.  The G2-add machine stays in the JAX package's slow tier.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky2_bn254_tpu.prover import prove as jprove
from plonky2_bn254_tpu.prover.config import TEST_CONFIG as JTEST_CONFIG
from plonky2_bn254_tpu.starks import fq_mul as jfq_mul
from plonky2_bn254_tpu.starks import g1_add as jg1_add
from plonky2_bn254_tpu.starks import limbs as jlimbs
from plonky2_bn254_tpu.starks.table import CtlSpec as JCtlSpec
from plonky2_bn254_tpu.starks.table import Stark as JStark
from plonky2_bn254_tpu_torch.bn254 import oracle, params
from plonky2_bn254_tpu_torch.interop import proof_to_fields, u64_from_tensor
from plonky2_bn254_tpu_torch.prover import prove as prove_mod
from plonky2_bn254_tpu_torch.prover import verify as verify_mod
from plonky2_bn254_tpu_torch.prover.config import TEST_CONFIG
from plonky2_bn254_tpu_torch.starks import fq_mul, g1_add, limbs
from test_micro_starks import (
    G1A_LAYOUT as JG1A_LAYOUT,
    MZ_LAYOUT as JMZ_LAYOUT,
    _eval_g1_add as _jeval_g1_add,
    _eval_mod_zero as _jeval_mod_zero,
    _g1_aux_cols as _jg1_aux_cols,
    _pad_rows as _jpad_rows,
)
from test_torch_prove import assert_fields_equal
from torch_tape_machines import g1_add_stark, mod_zero_stark

torch.set_num_threads(2)
N_ROWS = 64

def _pad_rows(rows: torch.Tensor) -> torch.Tensor:
    return torch.cat([rows, rows.new_zeros((N_ROWS - rows.shape[0], rows.shape[1]))])


def _g1_aux_cols(aux) -> list:
    def mz(m):
        return [m.is_quot_positive[..., None], m.quot_abs, m.aux_lo, m.aux_hi]

    return ([aux.is_x_eq[..., None], aux.is_x_eq_aux.inv] + mz(aux.is_x_eq_aux.modulus_zero_aux)
            + [aux.is_x_eq_filter[..., None], aux.lam] + mz(aux.lambda_aux) + mz(aux.x_aux)
            + mz(aux.y_aux))


def mod_zero_machines(rng):
    """(port stark, port trace, JAX stark, JAX trace, CTL values): a * b = c
    (mod p) rows, as tests/test_micro_starks.py builds them."""
    n = 10
    a_int = [oracle.random_fq(rng) for _ in range(n)]
    b_int = [oracle.random_fq(rng) for _ in range(n)]
    a, b = limbs.from_ints(a_int), limbs.from_ints(b_int)
    c, aux = fq_mul.generate_fq_mul(a, b)
    ones = torch.ones((n, 1), dtype=torch.int64)
    trace = _pad_rows(torch.cat([a, b, c, aux.is_quot_positive[..., None], aux.quot_abs,
                                 aux.aux_lo, aux.aux_hi, ones], dim=-1))
    ja, jb = jlimbs.from_ints(a_int), jlimbs.from_ints(b_int)
    jc, jaux = jfq_mul.generate_fq_mul(ja, jb)
    jtrace = _jpad_rows(jnp.concatenate([ja, jb, jc, jaux.is_quot_positive[..., None],
                                         jaux.quot_abs, jaux.aux_lo, jaux.aux_hi,
                                         jnp.ones((n, 1), jnp.int64)], axis=-1), JMZ_LAYOUT.width)
    cols = [("single", i) for i in range(48)]
    stark = mod_zero_stark()
    jstark = JStark(name="mod_zero_micro", width=JMZ_LAYOUT.width, eval_fn=_jeval_mod_zero,
                    lookups=[], ctls=[JCtlSpec(columns=cols, filter_col=JMZ_LAYOUT.col("filter"))])
    ctl = {0: [limbs.h_int_to_limbs(x, 16) + limbs.h_int_to_limbs(y, 16)
               + limbs.h_int_to_limbs(x * y % params.P, 16) for x, y in zip(a_int, b_int)]}
    return stark, trace, jstark, jtrace, ctl


def g1_add_machines(rng):
    """Unified add/double rows: alternating distinct adds and doublings."""
    pts = [oracle.random_g1(rng) for _ in range(8)]
    pairs = [(pts[i], pts[i + 1] if i % 2 == 0 else pts[i]) for i in range(7)]
    coords = [[p[0] for p, _ in pairs], [p[1] for p, _ in pairs],
              [q[0] for _, q in pairs], [q[1] for _, q in pairs]]
    n = len(pairs)
    ins = [limbs.from_ints(v) for v in coords]
    cx, cy, aux = g1_add.generate_g1_add(*ins)
    trace = _pad_rows(torch.cat(ins + [cx, cy] + _g1_aux_cols(aux)
                                + [torch.ones((n, 1), dtype=torch.int64)], dim=-1))
    jins = [jlimbs.from_ints(v) for v in coords]
    jcx, jcy, jaux = jg1_add.generate_g1_add(*jins)
    jtrace = _jpad_rows(jnp.concatenate(jins + [jcx, jcy] + _jg1_aux_cols(jaux)
                                        + [jnp.ones((n, 1), jnp.int64)], axis=-1),
                        JG1A_LAYOUT.width)
    cols = [("single", i) for i in range(96)]
    stark = g1_add_stark()
    jstark = JStark(name="g1_add_micro", width=JG1A_LAYOUT.width, eval_fn=_jeval_g1_add,
                    lookups=[], ctls=[JCtlSpec(columns=cols, filter_col=JG1A_LAYOUT.col("filter"))])
    ctl = {0: []}
    for p, q in pairs:
        s = oracle.g1_add(p, q)
        ctl[0].append(sum((limbs.h_int_to_limbs(v, 16) for v in (*p, *q, *s)), []))
    return stark, trace, jstark, jtrace, ctl


MACHINES = {"mod_zero": mod_zero_machines, "g1_add": g1_add_machines}


@pytest.mark.parametrize("name", list(MACHINES))
def test_micro_stark_both_transcripts_equal_jax(name):
    stark, trace, jstark, jtrace, ctl = MACHINES[name](np.random.default_rng(91))
    np.testing.assert_array_equal(u64_from_tensor(trace), np.asarray(jtrace).astype(np.uint64))
    host = prove_mod.prove(stark, trace, ctl, TEST_CONFIG, device_fs=False)
    dev = prove_mod.prove(stark, trace, ctl, TEST_CONFIG, device_fs=True)
    fields = proof_to_fields(dev)
    assert_fields_equal(fields, proof_to_fields(host))
    assert_fields_equal(fields, proof_to_fields(jprove.prove(jstark, jtrace, ctl, JTEST_CONFIG)))
    for proof in (host, dev):
        verify_mod.verify(stark, proof, ctl, TEST_CONFIG)
    bad = {0: [list(r) for r in ctl[0]]}
    bad[0][0][0] = (bad[0][0][0] + 1) % (1 << 16)
    with pytest.raises(verify_mod.VerificationError):
        verify_mod.verify(stark, dev, bad, TEST_CONFIG)
