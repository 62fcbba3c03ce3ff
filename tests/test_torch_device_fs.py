"""Fiat–Shamir on a device state against the host flow and the JAX package.

`prover/device_challenger.py` must squeeze what the host `Challenger`
squeezes on any schedule, and its tables (powers, CTL weights, CTL totals)
must equal the host's, as tests/test_device_challenger.py holds the JAX
package's; where the reference departs from the host challenger (an empty
absorb clears its outputs; ragged CTL rows fail), the port follows the host.
`prove(device_fs=True)` must equal the port's host-FS proof and the JAX
package's `prove(..., device_fs=True)` field by field (exact integer
arithmetic: tolerance zero), and both verifiers must accept it.  On the CPU
every transcript transition takes K2t's plain version.
"""

import numpy as np
import pytest
import torch

from plonky2_bn254_tpu.prover import prove as jprove
from plonky2_bn254_tpu.prover import verify as jverify
from plonky2_bn254_tpu.prover.config import TEST_CONFIG as JTEST_CONFIG
from plonky2_bn254_tpu.starks import demo as jdemo
from plonky2_bn254_tpu_torch.field import goldilocks as gl
from plonky2_bn254_tpu_torch.field import poseidon_cuda
from plonky2_bn254_tpu_torch.field.extension import GLExt
from plonky2_bn254_tpu_torch.interop import proof_to_fields, tensor_from_u64
from plonky2_bn254_tpu_torch.prover import constraints as cons
from plonky2_bn254_tpu_torch.prover import device_challenger as dc
from plonky2_bn254_tpu_torch.prover import prove as prove_mod
from plonky2_bn254_tpu_torch.prover import verify as verify_mod
from plonky2_bn254_tpu_torch.prover.challenger import Challenger
from plonky2_bn254_tpu_torch.prover.config import TEST_CONFIG
from plonky2_bn254_tpu_torch.prover.fri import domain_shifts_and_sizes
from plonky2_bn254_tpu_torch.starks import demo
from plonky2_bn254_tpu_torch.starks.table import g1_scalar_mul_stark
from test_torch_prove import assert_fields_equal, to_jax_proof

torch.set_num_threads(2)
RNG = np.random.default_rng(77)


def _ints(t) -> list:
    """u64 values of a tensor, or of a list of 0-d tensors."""
    if isinstance(t, list):
        t = torch.stack(t)
    return [gl.u64(int(v)) for v in t.reshape(-1)]


def _vec(xs) -> torch.Tensor:
    return tensor_from_u64(np.asarray(xs, dtype=np.uint64), "cpu")


def test_device_challenger_matches_host():
    """Random interleaved schedules: single elements, flat absorbs across
    partial buffers (an empty one among them), squeezes."""
    for trial in range(5):
        host, dev = Challenger(), dc.DeviceChallenger("cpu")
        for step in range(12):
            kind = int(RNG.integers(0, 3)) if step else 1
            if kind == 0:
                xs = [int(v) for v in RNG.integers(0, gl.P, size=int(RNG.integers(1, 7)),
                                                   dtype=np.uint64)]
                host.observe_elements(xs)
                for x in xs:
                    dev.observe_element(x)
            elif kind == 1:
                n = 0 if step == trial else int(RNG.integers(1, 40))
                xs = RNG.integers(0, gl.P, size=n, dtype=np.uint64)
                host.observe_elements([int(v) for v in xs])
                dev.observe_flat(_vec(xs))
            else:
                k = int(RNG.integers(1, 5))
                assert _ints(dev.get_n_challenges(k)) == host.get_n_challenges(k), (trial, step)
        assert _ints(dev.get_n_challenges(3)) == host.get_n_challenges(3)
        assert _ints(dev.state) == host.state


def test_empty_absorb_keeps_pending_outputs():
    """An absorb of nothing leaves the pending outputs, as the host
    challenger does (the reference's device challenger clears them)."""
    host, dev = Challenger(), dc.DeviceChallenger("cpu")
    host.observe_elements([5, 6, 7])
    dev.observe_flat(_vec([5, 6, 7]))
    assert _ints([dev.get_challenge()]) == [host.get_challenge()]
    host.observe_elements([])
    dev.observe_flat(_vec([]))
    assert dev.counts() == (0, len(host.output_buffer)) == (0, 7)
    assert _ints(dev.get_n_challenges(9)) == host.get_n_challenges(9)


def test_powers_and_ext_powers():
    b = int(RNG.integers(1, gl.P, dtype=np.uint64))
    assert _ints(dc.powers_vec(_vec(b), 20)) == [pow(b, j, gl.P) for j in range(20)]
    e = GLExt(int(RNG.integers(1, gl.P, dtype=np.uint64)),
              int(RNG.integers(1, gl.P, dtype=np.uint64)))
    rows = dc.ext_powers_rows(_vec(e.c0), _vec(e.c1), 13)
    cur = GLExt.one()
    for j in range(13):
        assert _ints(rows[j]) == [cur.c0, cur.c1]
        cur = cur * e


@pytest.mark.parametrize("ragged", [False, True])
def test_ctl_weights_and_totals_match_host(ragged, monkeypatch):
    """Weights against `flat_weights` and totals against `ctl_total`, for
    rows of one length and for ragged rows (zero-padded: a zero value adds
    nothing) and CTLs of different row counts, an empty one among them; the
    totals of every (challenge, CTL) pair take one batch inversion."""
    inversions = []
    batch_inv = gl.batch_inv
    monkeypatch.setattr(gl, "batch_inv", lambda x: inversions.append(x.shape) or batch_inv(x))
    stark = g1_scalar_mul_stark()
    betas = RNG.integers(1, gl.P, size=2, dtype=np.uint64)
    gammas = RNG.integers(1, gl.P, size=2, dtype=np.uint64)
    for beta in betas:
        for ctl, w in zip(stark.ctls, dc.ctl_weights_device(stark, _vec(beta))):
            assert _ints(w) == [wt for _, wt in ctl.flat_weights(int(beta), gl.P)]
    ctl_values = []
    for c, ctl in enumerate(stark.ctls):
        n_cols = len(ctl.flat_weights(1, gl.P))
        n_rows = 7 + 3 * c if ragged else 7
        lens = RNG.integers(1, n_cols + 1, size=n_rows) if ragged else [n_cols] * n_rows
        ctl_values.append([[int(v) for v in RNG.integers(0, gl.P, size=k, dtype=np.uint64)]
                           for k in lens])
    if ragged:
        ctl_values.append([])
    got = dc.ctl_totals_device([dc.ctl_rows_device(rows, "cpu") for rows in ctl_values],
                               _vec(betas), _vec(gammas))
    assert got.shape == (2, len(ctl_values))
    assert len(inversions) == 1
    for i, (beta, gamma) in enumerate(zip(betas, gammas)):
        want = [cons.ctl_total(rows, int(beta), int(gamma)) for rows in ctl_values]
        assert _ints(got[i]) == want


MACHINES = {
    "toy": (demo.demo_stark, demo.demo_trace, jdemo.demo_stark, jdemo.demo_trace, 31),
    "demo": (demo.demo_stark, demo.demo_trace, jdemo.demo_stark, jdemo.demo_trace, 11),
    "keyed": (demo.keyed_demo_stark, demo.keyed_demo_trace,
              jdemo.keyed_demo_stark, jdemo.keyed_demo_trace, 11),
}


@pytest.mark.parametrize("name", list(MACHINES))
def test_device_fs_proof_equals_host_and_jax(name):
    mk, mk_trace, jmk, jmk_trace, seed = MACHINES[name]
    trace, ctl = mk_trace(np.random.default_rng(seed))
    jtrace, _ = jmk_trace(np.random.default_rng(seed))
    proof = prove_mod.prove(mk(), trace, ctl, TEST_CONFIG, device_fs=True)
    fields = proof_to_fields(proof)
    assert_fields_equal(fields, proof_to_fields(
        prove_mod.prove(mk(), trace, ctl, TEST_CONFIG, device_fs=False)))
    assert_fields_equal(fields, proof_to_fields(
        jprove.prove(jmk(), jtrace, ctl, JTEST_CONFIG, device_fs=True)))
    verify_mod.verify(mk(), proof, ctl, TEST_CONFIG)
    jverify.verify(jmk(), to_jax_proof(fields), ctl, JTEST_CONFIG)
    proof.openings.aux_zeta_g[0] = proof.openings.aux_zeta_g[0] + GLExt(1)
    with pytest.raises(verify_mod.VerificationError):
        verify_mod.verify(mk(), proof, ctl, TEST_CONFIG)


def test_default_flow_follows_the_device(monkeypatch):
    """device_fs=None is the host flow on the CPU: no device challenger is
    made there unless asked for.  The device flow is one transcript
    transition (K2t, here its plain version) for each of fs1-fs4, one per
    FRI layer, one before the grind and one for the nonce and queries."""
    trace, ctl = demo.demo_trace(np.random.default_rng(4))
    made, transitions = [], []
    orig = dc.DeviceChallenger.__init__
    orig_transition = poseidon_cuda.sponge_transition

    def spy(self, device):
        made.append(torch.device(device))
        orig(self, device)

    def count(*args, **kwargs):
        transitions.append(args[3])
        return orig_transition(*args, **kwargs)

    monkeypatch.setattr(dc.DeviceChallenger, "__init__", spy)
    monkeypatch.setattr(poseidon_cuda, "sponge_transition", count)
    prove_mod.prove(demo.demo_stark(), trace, ctl, TEST_CONFIG)
    assert made == [] and transitions == []
    prove_mod.prove(demo.demo_stark(), trace, ctl, TEST_CONFIG, device_fs=True)
    assert made == [torch.device("cpu")]
    n_layers = len(domain_shifts_and_sizes(trace.shape[0].bit_length() - 1, TEST_CONFIG)[0])
    assert len(transitions) == 4 + n_layers + 2
    assert transitions[-2:] == [0, 1 + TEST_CONFIG.num_query_rounds]
