"""The device transcript, one transition per launch (K2t).

Random absorb and squeeze schedules from a numpy seed go through the port's
`DeviceChallenger` (K2t's plain version on the CPU), the host `Challenger`
and the JAX package's `DeviceChallenger` (driven as
tests/test_device_challenger.py drives it): every squeeze and every read of
the state must agree exactly.  The schedules reach every input fill level
0-7, absorb empty vectors, squeeze past 8 outputs and read the state as the
proof-of-work grind does.  The JAX challenger skips the empty absorbs: there
it clears the pending outputs, where the host challenger (and the port)
changes nothing (ROADMAP Queue 3).  `sponge_transition_plain` must equal the
host challenger's element-by-element schedule from any starting buffers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky2_bn254_tpu.prover import device_challenger as jdc
from plonky2_bn254_tpu_torch.field import goldilocks as gl
from plonky2_bn254_tpu_torch.field import poseidon_cuda
from plonky2_bn254_tpu_torch.interop import tensor_from_u64
from plonky2_bn254_tpu_torch.prover.challenger import Challenger
from plonky2_bn254_tpu_torch.prover.device_challenger import DeviceChallenger

torch.set_num_threads(2)


def _ints(t) -> list:
    return [gl.u64(int(v)) for v in t.reshape(-1)]


def _vec(xs) -> torch.Tensor:
    return tensor_from_u64(np.asarray(xs, dtype=np.uint64).reshape(-1), "cpu")


def _words(rng, n) -> list:
    return [int(v) for v in rng.integers(0, gl.P, size=n, dtype=np.uint64)]


def _schedule(rng, n_steps: int) -> list:
    """Steps: ("elements", words) absorbed one by one (python ints and 0-d
    tensors), ("flat", words) as one vector (some empty), ("squeeze", k)
    with k up to 12, and ("state",)."""
    steps = []
    for _ in range(n_steps):
        kind = int(rng.integers(0, 4))
        if kind == 0:
            steps.append(("elements", _words(rng, int(rng.integers(1, 8)))))
        elif kind == 1:
            n = int(rng.choice([0, int(rng.integers(1, 8)), int(rng.integers(8, 30))]))
            steps.append(("flat", _words(rng, n)))
        elif kind == 2:
            steps.append(("squeeze", int(rng.integers(1, 13))))
        else:
            steps.append(("state",))
    return steps + [("squeeze", 3), ("state",)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_schedules_agree_with_host_and_jax(seed):
    rng = np.random.default_rng(seed)
    host, dev, jax_dev = Challenger(), DeviceChallenger("cpu"), jdc.DeviceChallenger()
    for i, step in enumerate(_schedule(rng, 18)):
        if step[0] == "elements":
            host.observe_elements(step[1])
            for j, x in enumerate(step[1]):
                dev.observe_element(_vec([x])[0] if j % 2 else x)
                jax_dev.observe_element(jnp.uint64(x))
        elif step[0] == "flat":
            host.observe_elements(step[1])
            dev.observe_flat(_vec(step[1]))
            if step[1]:
                jax_dev.observe_flat(jnp.asarray(np.array(step[1], dtype=np.uint64)))
        elif step[0] == "squeeze":
            want = host.get_n_challenges(step[1])
            assert _ints(dev.get_n_challenges(step[1])) == want, (seed, i)
            assert [int(v) for v in jax_dev.get_n_challenges(step[1])] == want, (seed, i)
        else:
            assert _ints(dev.state) == host.state, (seed, i)
            assert [int(v) for v in np.asarray(jax_dev.state)] == host.state, (seed, i)
        assert dev.counts() == (len(host.input_buffer), len(host.output_buffer)), (seed, i)


def test_schedules_reach_every_fill_level():
    """Across the seeds of the schedule test, every fill level 0-7 occurs."""
    fills = set()
    for seed in range(4):
        rng, host = np.random.default_rng(seed), Challenger()
        for step in _schedule(rng, 18):
            if step[0] in ("elements", "flat"):
                host.observe_elements(step[1])
            elif step[0] == "squeeze":
                host.get_n_challenges(step[1])
            fills.add(len(host.input_buffer))
    assert fills == set(range(8))


# (pending words, absorbed words, pending outputs, squeezes): fill 0 and 7,
# an empty absorb, squeeze-only, more than 8 squeezes, whole chunks, a state
# flush that leaves words buffered.
EDGE_KEYS = [(0, 0, 0, 1), (0, 0, 5, 3), (0, 0, 5, 9), (7, 0, 0, 2), (7, 1, 0, 1),
             (0, 16, 0, 0), (0, 13, 0, 0), (3, 37, 0, 20), (0, 64, 0, 4), (2, 0, 0, 0)]


@pytest.mark.parametrize("key", EDGE_KEYS)
def test_plain_transition_equals_the_element_by_element_schedule(key):
    n_pending, n_words, n_out, n_squeeze = key
    rng = np.random.default_rng(sum(key))
    state = _words(rng, 12)
    pending, words = _words(rng, n_pending), _words(rng, n_words)
    host = Challenger()
    host.state = list(state)
    host.input_buffer = list(pending)
    host.output_buffer = state[:n_out]
    host.observe_elements(words)
    want = host.get_n_challenges(n_squeeze)
    cut = int(rng.integers(0, n_words + 1))
    vectors = [_vec(words[:cut]), *words[cut : cut + 2], _vec(words[cut + 2 :])]
    new_state, left, outputs = poseidon_cuda.sponge_transition(
        _vec(state), _vec(pending) if pending else None, vectors, n_squeeze, n_out)
    assert _ints(outputs) == want
    assert _ints(new_state) == host.state
    assert _ints(left) == host.input_buffer
    assert poseidon_cuda.sponge_schedule(n_pending + n_words, n_out, n_squeeze)[1:3] == (
        len(host.input_buffer), len(host.output_buffer))


def test_plain_batch_equals_one_by_one():
    """The lockstep batch (rows of different schedules) gives each row what
    a transition of its own gives."""
    rng = np.random.default_rng(5)
    states = _vec(_words(rng, 12 * len(EDGE_KEYS))).reshape(-1, 12)
    streams = [_vec(_words(rng, p + n)) for p, n, _, _ in EDGE_KEYS]
    got = poseidon_cuda.sponge_transitions_plain(
        states, streams, [k[2] for k in EDGE_KEYS], [k[3] for k in EDGE_KEYS])
    for b, (_, _, n_out, k) in enumerate(EDGE_KEYS):
        want = poseidon_cuda.sponge_transition_plain(states[b], None, [streams[b]], k, n_out)
        for g, w in zip(got[b], want):
            assert torch.equal(g, w)


def test_one_transition_per_squeeze(monkeypatch):
    """Absorbs queue; a squeeze or a state read is one transition; squeezes
    served by pending outputs make none."""
    calls = []
    orig = poseidon_cuda.sponge_transition

    def spy(state, pending, vectors, n_squeeze, n_out=0):
        calls.append((0 if pending is None else int(pending.shape[0]), n_squeeze, n_out))
        return orig(state, pending, vectors, n_squeeze, n_out)

    monkeypatch.setattr(poseidon_cuda, "sponge_transition", spy)
    rng = np.random.default_rng(9)
    host, dev = Challenger(), DeviceChallenger("cpu")
    for x in _words(rng, 3):
        host.observe_element(x)
        dev.observe_element(x)
    words = _words(rng, 21)
    host.observe_elements(words)
    dev.observe_flat(_vec(words))
    assert calls == []
    assert _ints(dev.get_n_challenges(4)) == host.get_n_challenges(4)
    assert _ints(dev.get_n_challenges(2)) == host.get_n_challenges(2)
    assert calls == [(0, 4, 0)]
    host.observe_elements([7, 8, 9])
    dev.observe_flat(_vec([7, 8, 9]))
    assert _ints(dev.state) == host.state
    assert calls[-1] == (0, 0, 2)
    assert _ints(dev.get_n_challenges(10)) == host.get_n_challenges(10)
    assert calls[-1] == (3, 10, 0)
    assert len(calls) == 3


def test_a_long_queue_splits_into_launches_of_the_kernel_limits(monkeypatch):
    """More segments than one launch takes: the queue is absorbed in parts,
    with the same squeezes."""
    calls = []
    orig = poseidon_cuda.sponge_transition

    def spy(state, pending, vectors, n_squeeze, n_out=0):
        calls.append(len(vectors))
        return orig(state, pending, vectors, n_squeeze, n_out)

    monkeypatch.setattr(poseidon_cuda, "sponge_transition", spy)
    rng = np.random.default_rng(10)
    host, dev = Challenger(), DeviceChallenger("cpu")
    for i in range(poseidon_cuda.MAX_SEGMENTS + 5):
        x = _words(rng, 1 + i % 2)
        host.observe_elements(x)
        if len(x) > 1:
            dev.observe_flat(_vec(x))
        else:
            dev.observe_element(_vec(x)[0])
    assert _ints(dev.get_n_challenges(2)) == host.get_n_challenges(2)
    assert len(calls) == 2 and max(calls) <= poseidon_cuda.MAX_SEGMENTS


@pytest.mark.parametrize("how", ["flat", "element"])
def test_a_queued_tensor_written_before_the_squeeze_raises(how):
    """Absorbs are read at the next squeeze, so a write to a queued tensor
    in between would change the transcript: the squeeze raises instead."""
    words = _vec([1, 2, 3])
    dev = DeviceChallenger("cpu")
    if how == "flat":
        dev.observe_flat(words)
    else:
        dev.observe_element(words[1])
    words[1] = 5
    with pytest.raises(RuntimeError, match="written"):
        dev.get_challenge()
    host, again = Challenger(), DeviceChallenger("cpu")
    host.observe_elements([1, 2, 3] if how == "flat" else [2])
    if how == "flat":
        again.observe_flat(_vec([1, 2, 3]))
    else:
        again.observe_element(_vec([1, 2, 3])[1])
    assert _ints(again.get_n_challenges(2)) == host.get_n_challenges(2)
