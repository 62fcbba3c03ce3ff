"""Hand-written CUDA kernels K1-K7, K1m and K2t against their plain PyTorch versions.

These need an NVIDIA card with nvcc and skip without one.  On the card:
    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest
(`--noconftest`: tests/conftest.py sets up JAX, which the card's machine
need not have; this file imports none.  chip_smoke.py runs the same
comparisons at the main path's full shapes.)
"""

import json

import numpy as np
import pytest
import torch

from plonky2_bn254_tpu_torch import kernels
from plonky2_bn254_tpu_torch.field import goldilocks as gl
from plonky2_bn254_tpu_torch.field import ntt_cuda, poseidon_cuda
from plonky2_bn254_tpu_torch.interop import proof_to_fields, tensor_from_u64

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels compile and run only on the card)")
    return torch.device("cuda", 0)


def _rand(shape, device, seed=0, full_range=False):
    hi = 2**64 - 1 if full_range else gl.P - 1
    x = np.random.default_rng(seed).integers(0, hi, size=shape, dtype=np.uint64, endpoint=True)
    return tensor_from_u64(x, device)


@pytest.mark.parametrize("shape", [(1, 781), (300, 781), (1000, 8), (7, 13), (3, 0)])
def test_k1_hash_leaves(card, shape):
    x = _rand(shape, card, full_range=True)
    before = kernels.LAUNCHES["K1"]
    got = poseidon_cuda.hash_leaves(x)
    assert kernels.LAUNCHES["K1"] == before + 1
    assert torch.equal(got, poseidon_cuda.hash_leaves_plain(x))


EDGE_WORDS = [0, 1, 2, gl.P - 2, gl.P - 1, gl.P, gl.P + 1, 2**64 - 2, 2**64 - 1,
              2**32 - 1, 2**32, 2**63, 0xFFFFFFFF00000000, 0xFFFFFFFE00000001]


def test_k1_k2_edge_words(card):
    """Every pair of carry and borrow edge words through the carry-chain
    arithmetic of csrc/goldilocks.cuh, as states and as leaves."""
    edge = np.array(EDGE_WORDS, dtype=np.uint64)
    pairs = np.stack(np.meshgrid(edge, edge), -1).reshape(-1, 2)
    states = tensor_from_u64(np.tile(pairs, (1, 6)), card)
    assert torch.equal(poseidon_cuda.permute_states(states), poseidon_cuda.permute_states_plain(states))
    leaves = tensor_from_u64(np.tile(pairs, (1, 5))[:, :9], card)
    assert torch.equal(poseidon_cuda.hash_leaves(leaves), poseidon_cuda.hash_leaves_plain(leaves))


@pytest.mark.parametrize("n", [1, 129, 4096])
def test_k2_permute_states(card, n):
    x = _rand((n, 12), card, full_range=True)
    assert torch.equal(poseidon_cuda.permute_states(x), poseidon_cuda.permute_states_plain(x))


def test_k2_single_state_in_the_device_challenger(card):
    """The device challenger no longer duplexes through K2 at [1, 12]: the
    same squeezes as the host challenger, one K2t launch for the absorb and
    the 11 squeezes, none of K2."""
    from plonky2_bn254_tpu_torch.prover.challenger import Challenger
    from plonky2_bn254_tpu_torch.prover.device_challenger import DeviceChallenger

    x = _rand((1, 12), card, full_range=True)
    assert torch.equal(poseidon_cuda.permute_states(x), poseidon_cuda.permute_states_plain(x))
    xs = np.random.default_rng(8).integers(0, gl.P, size=37, dtype=np.uint64)
    host, dev = Challenger(), DeviceChallenger(card)
    kernels.reset_launches()
    host.observe_elements([int(v) for v in xs])
    dev.observe_flat(tensor_from_u64(xs, card))
    got = dev.get_n_challenges(11).cpu().numpy().view(np.uint64)
    assert [int(v) for v in got] == host.get_n_challenges(11)
    assert dict(kernels.CALLS["K2"]) == {}
    assert dict(kernels.CALLS["K2t"]) == {(0, 37, 0, 11): 1}


@pytest.mark.parametrize("offset", [-1, 0, 1])
def test_k1_both_sides_of_the_regime_threshold(card, offset):
    """K1 at w = 8 just below, at and above the rows where the wrapper
    switches to the throughput kernel."""
    rows = poseidon_cuda.device_threshold("K1", card) + offset
    assert poseidon_cuda.device_regime("K1", rows, card) == ("latency" if offset < 0 else "throughput")
    x = _rand((rows, 8), card, full_range=True)
    assert torch.equal(poseidon_cuda.hash_leaves(x), poseidon_cuda.hash_leaves_plain(x))


@pytest.mark.parametrize("regime", ["throughput", "latency"])
@pytest.mark.parametrize("shape", [(1, 781), (3, 781), (300, 781), (1000, 8), (7, 13), (3, 0),
                                   (5, 9), (33, 16), (4096, 134)])
def test_k1_each_regime(card, shape, regime):
    x = _rand(shape, card, full_range=True)
    assert torch.equal(poseidon_cuda.launch_hash_leaves(x, regime), poseidon_cuda.hash_leaves_plain(x))


@pytest.mark.parametrize("regime", ["throughput", "latency"])
@pytest.mark.parametrize("n", [1, 129, 4096, 1 << 20])
def test_k2_each_regime(card, n, regime):
    x = _rand((n, 12), card, full_range=True)
    assert torch.equal(poseidon_cuda.launch_permute_states(x, regime),
                       poseidon_cuda.permute_states_plain(x))


def test_k2_grinds_take_their_regimes(card):
    """The PoW grind of DEFAULT_CONFIG ([2^20, 12]) runs in the throughput
    regime, h2g's 8-bit grind ([4096, 12]) in the latency regime."""
    assert poseidon_cuda.device_regime("K2", 1 << 20, card) == "throughput"
    assert poseidon_cuda.device_regime("K2", 4096, card) == "latency"


# (digests, levels): a 2^17-leaf tree to cap 4 (its two lowest levels
# through K1), 2^13 to cap 0, 2 leaves, FRI-layer trees, an uneven count
TREE_SHAPES = [(1 << 17, 13), (1 << 13, 13), (2, 1), (64, 2), (8192, 9), (1 << 15, 11), (768, 8)]


@pytest.mark.parametrize("n, n_levels", TREE_SHAPES)
def test_k1m_tree_levels(card, n, n_levels):
    d = _rand((n, 4), card)
    kernels.reset_launches()
    got = poseidon_cuda.hash_tree_levels(d, n_levels)
    assert kernels.LAUNCHES["K1m"] == 1
    want = poseidon_cuda.hash_tree_levels_plain(d, n_levels)
    assert len(got) == len(want) == n_levels
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_k1m_one_launch_for_a_whole_large_tree(card):
    """K1m given every level of a 2^17-digest tree: 512 blocks, top levels
    of more rows than one block holds."""
    d = _rand((1 << 17, 4), card)
    got = poseidon_cuda.launch_tree_levels(d, 17)
    for g, w in zip(got, poseidon_cuda.hash_tree_levels_plain(d, 17)):
        assert torch.equal(g, w)


# (pending words, absorbed words, pending outputs, squeezes): fill 0 and 7, an
# empty absorb, squeeze-only, more than 8 squeezes, a flush that leaves words
# buffered, a long absorb (chip_smoke.py adds 9,000 words: its plain version
# takes a minute on the card).
K2T_KEYS = [(0, 0, 0, 1), (0, 0, 5, 3), (0, 0, 5, 9), (7, 0, 0, 2), (7, 1, 0, 1), (0, 13, 0, 0),
            (3, 37, 0, 20), (0, 65, 0, 4), (2, 0, 0, 0), (0, 203, 6, 2)]


@pytest.mark.parametrize("key", K2T_KEYS)
def test_k2t_sponge_transition(card, key):
    """K2t equals the plain version: the state, the leftover words and the
    outputs, with words from device vectors (some empty) and by value, and
    edge words in the state."""
    n_pending, n_words, n_out, n_squeeze = key
    rng = np.random.default_rng(sum(key))
    state = _rand((12,), card, seed=sum(key), full_range=True)
    state[:3] = tensor_from_u64(np.array([gl.P, 2**64 - 1, 0], dtype=np.uint64), card)
    pending = _rand((n_pending,), card, seed=1) if n_pending else None
    words = _rand((n_words,), card, seed=2)
    cut = int(rng.integers(0, n_words + 1))
    vectors = [words[:cut], words[:0], *[int(v) for v in words[cut : cut + 3].cpu().numpy().view(np.uint64)],
               words[cut + 3 :]]
    kernels.reset_launches()
    got = poseidon_cuda.sponge_transition(state, pending, vectors, n_squeeze, n_out)
    assert dict(kernels.CALLS["K2t"]) == {key: 1}
    want = poseidon_cuda.sponge_transition_plain(state, pending, vectors, n_squeeze, n_out)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_k2t_rejects_what_it_does_not_take(card):
    state = _rand((12,), card)
    words = _rand((16, 2), card)
    with pytest.raises(ValueError):
        poseidon_cuda.sponge_transition(state, None, [words.T[0]], 1)  # not contiguous
    with pytest.raises(ValueError):
        poseidon_cuda.sponge_transition(state, None, [words[:, 0].cpu()], 1)  # other device
    with pytest.raises(ValueError):
        poseidon_cuda.sponge_transition(state, None, list(range(poseidon_cuda.MAX_IMMEDIATE + 1)), 1)


# Every split of the two-pass plan and the one-pass/two-pass boundary (2^10 /
# 2^11), at widths 1, 7 and 781 while the plain version fits on the card.
NTT_SHAPES = [(1, 1), (5, 8), (8192, 16), (13, 1 << 12), (3, 1 << 13), (2, 1 << 15)] + [
    (w, 1 << k) for k in (10, 11, 12, 13, 16, 17, 20) for w in (1, 7, 781) if w << k <= 781 << 16
]


@pytest.mark.parametrize("shape", NTT_SHAPES)
def test_k3_ntt_intt(card, shape):
    x = _rand(shape, card)
    assert torch.equal(ntt_cuda.ntt(x), ntt_cuda.ntt_plain(x))
    assert torch.equal(ntt_cuda.intt(x), ntt_cuda.intt_plain(x))


def test_k3_size_one_keeps_non_canonical_words(card):
    x = tensor_from_u64(np.array([[2**64 - 1], [gl.P], [5]], dtype=np.uint64), card)
    assert torch.equal(ntt_cuda.ntt(x), x)
    assert torch.equal(ntt_cuda.intt(x), x)


def test_k3_two_pass_counts_one_launch(card):
    x = _rand((3, 1 << 16), card)
    before = kernels.LAUNCHES["K3"]
    ntt_cuda.intt(x)
    assert kernels.LAUNCHES["K3"] == before + 1


LDE_SHAPES = [((1, 1), 1), ((5, 8), 1), ((7, 1 << 11), 1), ((3, 1 << 12), 2)] + [
    ((w, 1 << k), rate) for k in (9, 10, 11, 12, 15, 16, 18) for w in (1, 7, 781)
    for rate in (1, 2) if w << (k + rate) <= 781 << 17
]


@pytest.mark.parametrize("shape,rate", LDE_SHAPES)
def test_k4_coset_lde(card, shape, rate):
    x = _rand(shape, card)
    assert torch.equal(ntt_cuda.coset_lde(x, rate), ntt_cuda.coset_lde_plain(x, rate))


def test_wrappers_reject_non_contiguous(card):
    x = _rand((16, 32), card)
    with pytest.raises(ValueError):
        ntt_cuda.ntt(x.T)
    with pytest.raises(ValueError):
        poseidon_cuda.hash_leaves(x.T)


def test_demo_proof_on_card_equals_cpu(card):
    from plonky2_bn254_tpu_torch.prover import prove as prove_mod
    from plonky2_bn254_tpu_torch.prover.config import TEST_CONFIG
    from plonky2_bn254_tpu_torch.starks.demo import demo_stark, demo_trace

    trace, ctl = demo_trace(np.random.default_rng(3))
    kernels.reset_launches()
    on_card = proof_to_fields(prove_mod.prove(demo_stark(), trace.to(card), ctl, TEST_CONFIG))
    assert all(kernels.LAUNCHES[k] > 0 for k in kernels.KERNEL_IDS)
    on_cpu = proof_to_fields(prove_mod.prove(demo_stark(), trace, ctl, TEST_CONFIG))
    as_json = lambda f: json.dumps(f, default=lambda v: v.tolist())
    assert as_json(on_card) == as_json(on_cpu)


def test_demo_device_fs_proof_on_card_equals_cpu(card):
    """Both transcripts on the card give the CPU's host-FS proof; the device
    flow runs its transitions through K2t, never K2 at [1, 12]."""
    from plonky2_bn254_tpu_torch.prover import prove as prove_mod
    from plonky2_bn254_tpu_torch.prover import verify as verify_mod
    from plonky2_bn254_tpu_torch.prover.config import TEST_CONFIG
    from plonky2_bn254_tpu_torch.prover.fri import domain_shifts_and_sizes
    from plonky2_bn254_tpu_torch.starks.demo import demo_stark, demo_trace

    trace, ctl = demo_trace(np.random.default_rng(5))
    as_json = lambda p: json.dumps(proof_to_fields(p), default=lambda v: v.tolist())
    want = as_json(prove_mod.prove(demo_stark(), trace, ctl, TEST_CONFIG, device_fs=False))
    kernels.reset_launches()
    proof = prove_mod.prove(demo_stark(), trace.to(card), ctl, TEST_CONFIG, device_fs=True)
    n_layers = len(domain_shifts_and_sizes(trace.shape[0].bit_length() - 1, TEST_CONFIG)[0])
    assert kernels.LAUNCHES["K2t"] == 4 + n_layers + 2
    assert kernels.CALLS["K2"][(1,)] == 0
    assert all(kernels.LAUNCHES[k] > 0 for k in kernels.KERNEL_IDS)
    assert as_json(proof) == want
    verify_mod.verify(demo_stark(), proof, ctl, TEST_CONFIG)
    kernels.reset_launches()
    host = prove_mod.prove(demo_stark(), trace.to(card), ctl, TEST_CONFIG, device_fs=False)
    assert kernels.CALLS["K2"][(1,)] == 0 and kernels.LAUNCHES["K2t"] == 0
    assert as_json(host) == want


def test_map_to_g2_real_backend_on_card(card):
    """tests/test_hash_to_g2_real.py through the port on the card: the hook
    proves the two fq_exp Legendre candidates and the blinded g2_scalar_mul
    cofactor at witness time; the output equals the native mirror."""
    from plonky2_bn254_tpu_torch.bn254 import oracle
    from plonky2_bn254_tpu_torch.circuit import builder_ops
    from plonky2_bn254_tpu_torch.circuit import hash_to_g2 as h2g
    from plonky2_bn254_tpu_torch.circuit.builder import CircuitBuilder, Witness
    from plonky2_bn254_tpu_torch.circuit.fq2 import Fq2Target
    from plonky2_bn254_tpu_torch.prover.config import StarkConfig

    rng = np.random.default_rng(170)
    uv = (oracle.random_fq(rng), oracle.random_fq(rng))
    b = CircuitBuilder()
    hook = builder_ops.get_bn254_hook(b)
    hook.stark_config = StarkConfig(num_challenges=2, rate_bits=1, cap_height=1,
                                    proof_of_work_bits=8, num_query_rounds=4, arity_bits=2,
                                    final_poly_degree_bits=3)
    u = Fq2Target.new_unchecked(b)
    out = h2g.map_to_g2_circuit(b, u)
    pw = Witness()
    u.set_witness(pw, uv)
    kernels.reset_launches()
    values, proofs = b.build().prove(pw, device=card)
    assert out.get_witness(values) == h2g.map_to_g2(uv)
    assert {"fq_exp", "g2_scalar_mul"} <= set(proofs["bn254"])
    assert all(kernels.LAUNCHES[k] > 0 for k in kernels.KERNEL_IDS)


@pytest.mark.parametrize("machine", ["fq_exp", "g2_scalar_mul"])
def test_trace_on_card_equals_cpu(card, machine):
    """The FqExp and G2 traces built on the card equal the same traces built
    on the CPU (plain torch, exact integer arithmetic)."""
    from plonky2_bn254_tpu_torch.bn254 import oracle
    from plonky2_bn254_tpu_torch.starks import fq_exp, g2_scalar_mul

    rng = np.random.default_rng(12)
    if machine == "fq_exp":
        mod = fq_exp
        inputs = [(int(rng.integers(1, 1 << 63)) << 190 | t, oracle.random_fq(rng), t)
                  for t in range(3)]
    else:
        mod = g2_scalar_mul
        inputs = [(int(rng.integers(1, 1 << 63)) << 190 | t, oracle.random_g2(rng),
                   oracle.random_g2(rng), t) for t in range(2)]
    on_card = mod.generate_trace(inputs, min_rows=2048)
    assert on_card.device.type == "cuda"
    assert torch.equal(on_card.cpu(), mod.generate_trace(inputs, min_rows=2048, device="cpu"))


def test_compose_three_kinds_on_card(card):
    """The three-kinds flow of tests/test_compose_three_kinds.py through the
    port on the card: 10 fq_exp, 10 G1 and 10 G2 ops on one builder, three
    inner batch proofs at a small config injected at witness time, ONE outer
    proof that `verify_all` accepts, and per op kind a corrupted opening of
    the injected proof that makes the outer proof reject."""
    from plonky2_bn254_tpu_torch.bn254 import oracle, params
    from plonky2_bn254_tpu_torch.circuit import builder_ops, outer
    from plonky2_bn254_tpu_torch.circuit.builder import CircuitBuilder, Witness
    from plonky2_bn254_tpu_torch.circuit.curves import G1Target, G2Target
    from plonky2_bn254_tpu_torch.circuit.fq import FqTarget
    from plonky2_bn254_tpu_torch.prover.config import TEST_CONFIG, StarkConfig
    from plonky2_bn254_tpu_torch.prover.verify import VerificationError

    rng = np.random.default_rng(301)
    b = CircuitBuilder()
    hook = builder_ops.get_bn254_hook(b)
    hook.stark_config = StarkConfig(num_challenges=2, rate_bits=1, cap_height=1,
                                    proof_of_work_bits=8, num_query_rounds=4, arity_bits=2,
                                    final_poly_degree_bits=3)
    pw = Witness()
    recs = {"fq_exp": [], "g1_scalar_mul": [], "g2_scalar_mul": []}

    def scalar():
        return int(rng.integers(1, 1 << 62)) << 180 | int(rng.integers(0, 1 << 62))

    for _ in range(10):
        s_v, x_v = scalar(), oracle.random_fq(rng)
        x_t = FqTarget.new_unchecked(b)
        out = builder_ops.fq_exp(b, s_v, x_t)
        x_t.set_witness(pw, x_v)
        recs["fq_exp"].append((out, pow(x_v, s_v, params.P)))
    for kind, target, point, mul, add in (
        ("g1_scalar_mul", G1Target, oracle.random_g1, oracle.g1_mul, oracle.g1_add),
        ("g2_scalar_mul", G2Target, oracle.random_g2, oracle.g2_mul, oracle.g2_add),
    ):
        op = getattr(builder_ops, kind)
        for _ in range(10):
            s_v, x_v, off_v = scalar(), point(rng), point(rng)
            x_t, off_t = target.new_unchecked(b), target.new_unchecked(b)
            out = op(b, s_v, x_t, off_t)
            x_t.set_witness(pw, x_v)
            off_t.set_witness(pw, off_v)
            recs[kind].append((out, add(mul(x_v, s_v), off_v)))
    for t in recs["fq_exp"][0][0].value.limbs:
        b.register_public_input(t)
    circuit = b.build()

    values = circuit.generate_witness(pw, card)
    assert set(hook.proof) == set(recs)
    for rows in recs.values():
        for out, want in rows:
            assert out.get_witness(values) == want
    data = circuit.outer_data(device=card)
    kernels.reset_launches()
    proof, publics = outer.prove_outer(data, values, TEST_CONFIG)
    assert all(kernels.LAUNCHES[k] > 0 for k in kernels.KERNEL_IDS)
    circuit.verify_all(proof, publics, TEST_CONFIG, device=card)
    assert sum(v << (32 * i) for i, v in enumerate(publics)) == recs["fq_exp"][0][1]
    for kind in recs:
        bad = dict(values)
        idx = hook.proof_targets[kind].trace_zeta[0].c0.index
        bad[idx] = (bad[idx] + 1) % gl.P
        p_bad, pub_bad = outer.prove_outer(data, bad, TEST_CONFIG)
        with pytest.raises(VerificationError):
            outer.verify_outer(data, p_bad, pub_bad, TEST_CONFIG)


def test_g1_msm_real_backend_on_card(card):
    """The twin of tests/test_msm_hash_real.py::test_g1_msm_real_backend
    through the port on the card: an 8-term g1_msm through the hook with
    the real backend (the 8 chained g1_scalar_mul ops in ONE batch STARK
    proof at the hook's recursion config, self-verified and injected); the
    result equals the native oracle's sum and the circuit checks."""
    from plonky2_bn254_tpu_torch import circuit as ckt
    from plonky2_bn254_tpu_torch.bn254 import oracle
    from plonky2_bn254_tpu_torch.circuit import msm
    from plonky2_bn254_tpu_torch.circuit.curves import G1Target
    from plonky2_bn254_tpu_torch.prover.config import StarkConfig

    rng = np.random.default_rng(501)
    b = ckt.CircuitBuilder()
    hook = ckt.get_bn254_hook(b)
    hook.stark_config = StarkConfig(num_challenges=2, rate_bits=1, cap_height=1,
                                    proof_of_work_bits=8, num_query_rounds=4, arity_bits=2,
                                    final_poly_degree_bits=3)
    assert hook.prove_starks
    pw = ckt.Witness()
    scalars = [int(rng.integers(1, 1 << 62)) for _ in range(8)]
    pts = [oracle.random_g1(rng) for _ in range(8)]
    pts_t = [G1Target.new_unchecked(b) for _ in range(8)]
    out = msm.g1_msm(b, scalars, pts_t)
    for t, v in zip(pts_t, pts):
        t.set_witness(pw, v)
    values, proofs = b.build().prove(pw, card)
    want = None
    for sv, p in zip(scalars, pts):
        term = oracle.g1_mul(p, sv)
        want = term if want is None else oracle.g1_add(want, term)
    assert out.get_witness(values) == want
    assert "g1_scalar_mul" in proofs["bn254"]
    assert len(hook.inputs_g1) == 8


def test_mesh_transforms_on_two_gloo_ranks_on_one_card(card):
    """Two gloo ranks share the card (their blocks on cuda:0, exchanged
    through the host): mesh_ntt, mesh_intt and mesh_coset_lde_rate1 at
    [8, 2^12] equal the single-device kernels' transforms, and
    distributed_ntt of the [64, 512] view equals single_device_reference,
    with K3 launched on each rank."""
    from plonky2_bn254_tpu_torch.parallel import launch
    from plonky2_bn254_tpu_torch.parallel import ntt as pntt
    from torch_parallel_case import card_rank_case

    x = np.random.default_rng(12).integers(0, gl.P, size=(8, 1 << 12), dtype=np.uint64)
    kernels.library()  # built once here, loaded by the ranks
    ranks = launch.run(card_rank_case, 2, x, timeout=600)
    xt = tensor_from_u64(x, card)
    want = {"mesh_ntt": ntt_cuda.ntt(xt), "mesh_intt": ntt_cuda.intt(xt),
            "mesh_lde": ntt_cuda.coset_lde(xt, 1)}
    for key, w in want.items():
        got = np.concatenate([r[key] for r in ranks], axis=1)
        np.testing.assert_array_equal(got, w.cpu().numpy().view(np.uint64), err_msg=key)
    got = np.concatenate([r["distributed_ntt"] for r in ranks], axis=0)
    want = pntt.single_device_reference(tensor_from_u64(x.reshape(64, -1), card))
    np.testing.assert_array_equal(got, want.cpu().numpy().view(np.uint64))
    for r in ranks:
        assert (r["device"], r["wire"]) == ("cuda:0", "cpu")
        assert r["K3"] == 6  # mesh_ntt, mesh_intt, the LDE's two NTTs, distributed_ntt's two


def test_mesh_device_fs_and_2d_proofs_on_four_gloo_ranks_on_one_card(card):
    """Four gloo ranks share the card: the demo's device-FS proof on the
    1-D mesh and its proof with the rows over ("tp", "dp") of the (2, 2)
    mesh each equal the single-device proof on the card on every rank;
    K1, K2 and K3 launch on every rank, K4 never, K2t only with the device
    transcript."""
    from plonky2_bn254_tpu_torch.parallel import launch
    from plonky2_bn254_tpu_torch.prover import prove as prove_mod
    from plonky2_bn254_tpu_torch.prover.config import TEST_CONFIG
    from plonky2_bn254_tpu_torch.starks.demo import demo_stark
    from torch_parallel_case import card_mesh_prove_case, demo_inputs

    inputs = demo_inputs(61)
    kernels.library()  # built once here, loaded by the ranks
    ranks = launch.run(card_mesh_prove_case, 4, inputs, timeout=600)
    single = proof_to_fields(prove_mod.prove(
        demo_stark(), inputs["demo_trace"].to(card), inputs["demo_ctl"], TEST_CONFIG))
    as_json = lambda f: json.dumps(f, default=lambda v: v.tolist())
    for r in ranks:
        for name, res in r.items():
            assert as_json(res["proof"]) == as_json(single), name
            n = res["launches"]
            assert min(n["K1"], n["K2"], n["K3"]) > 0 and n["K4"] == 0, (name, n)
            assert (n["K2t"] > 0) == (name == "device_fs_1d"), (name, n)


def test_nccl_ranks_sharing_one_card_raise(card):
    """make_mesh refuses an NCCL group whose ranks share a card, before any
    NCCL collective could hang."""
    import torch.distributed as dist

    from plonky2_bn254_tpu_torch.parallel import launch
    from torch_parallel_case import nccl_rank_case

    if not dist.is_nccl_available():
        pytest.skip("this torch has no NCCL")
    if torch.cuda.device_count() > 1:
        pytest.skip("two cards: the ranks would not share one")
    with pytest.raises(RuntimeError, match="share a card"):
        launch.run(nccl_rank_case, 2, backend="nccl", timeout=300)


def _measurement_scripts_on_path():
    import pathlib
    import sys

    repo = pathlib.Path(__file__).resolve().parent.parent
    for p in (repo, repo / "scripts"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def test_bench_measure_fq_exp_on_card(card):
    """bench_torch.py's measuring function on the 128-op FqExp batch at
    DEFAULT_CONFIG, one repeat: the gate passes, every key is there, and
    the result names the card."""
    _measurement_scripts_on_path()
    import bench_torch
    from plonky2_bn254_tpu_torch.prover.config import DEFAULT_CONFIG

    res = bench_torch.measure("fq_exp", 128, DEFAULT_CONFIG, 1, card)
    assert res["verified"] is True and res["n"] == 1
    assert res["value"] == 128 / res["median_s"] and res["median_s"] == res["walls_s"][0]
    assert res["peak_gb"] > 0 and res["build_s"] >= 0 and res["warmup_s"] > 0
    assert {"trace gen", "trace commit", "fs1", "aux", "quotient", "fri"} <= set(res["stages_s"])
    dev = res["device"]
    assert dev["platform"] == "gpu" and dev["count"] == torch.cuda.device_count()
    assert dev["before"]["sm_clock"] and dev["after"]["power_draw"]


def test_bench_outer_gate_path_on_card(card):
    """scripts/torch_bench_outer.py's run with one repeat: outputs equal
    pow(x, s, P), verify_all accepts, a corrupted public value is rejected."""
    _measurement_scripts_on_path()
    import torch_bench_outer

    marks = []
    res = torch_bench_outer.run(card, 1, marks.append)
    assert res["verified"] is True and res["stages"]["corrupted_public_rejected"] is True
    assert res["metric"] == "composed_outer_prove_steady_s" and res["value"] == res["median_s"]
    assert res["stages"]["outer_rows_log2"] == 20 and res["n"] == 1
    assert marks[-1] == "corrupted public input rejected"


def _fq_exp_inputs(seed: int, n: int = 2):
    from plonky2_bn254_tpu_torch.bn254 import oracle

    rng = np.random.default_rng(seed)
    return [(int(rng.integers(1, 1 << 62)) << 150 | t, oracle.random_fq(rng), t) for t in range(n)]


def _traced(run):
    """run() under torch.profiler (CPU and CUDA) and an enabled TimingTree:
    (its spans, the profiler's events)."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    from plonky2_bn254_tpu_torch.utils import timing

    gc.collect()
    timing.reset()
    tt = timing.TimingTree(enabled=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("warm-up"):  # the profiler's first event sets it up
            pass
        run(tt)
        torch.cuda.synchronize()
    spans = timing.spans()
    del tt
    timing.reset()
    return spans, list(prof.profiler.kineto_results.events())


def test_spans_on_the_profilers_clock_on_card(card):
    """An FqExp prove under the profiler: every program span is a `scope:`
    annotation within 1 ms of its recorded host times, and its device
    close is no earlier than the end of the last device operation
    launched inside it (within the same 1 ms)."""
    from collections import defaultdict

    from plonky2_bn254_tpu_torch.prover import prove as prove_mod
    from plonky2_bn254_tpu_torch.prover.config import TEST_CONFIG
    from plonky2_bn254_tpu_torch.starks import fq_exp
    from plonky2_bn254_tpu_torch.starks.table import fq_exp_stark
    from plonky2_bn254_tpu_torch.utils.timing import ANNOTATION

    inputs = _fq_exp_inputs(21)
    trace = fq_exp.generate_trace(inputs, min_rows=2048)
    ctl = fq_exp.generate_ctl_values(inputs)
    spans, events = _traced(lambda tt: prove_mod.prove(fq_exp_stark(), trace, ctl, TEST_CONFIG,
                                                       timing=tt))
    assert spans[-1].name == "prove" and len(spans) > 10
    dev = torch.autograd.DeviceType.CUDA
    notes = defaultdict(list)
    for e in events:
        if e.device_type() != dev and e.name().startswith(ANNOTATION):
            notes[e.name()[len(ANNOTATION):]].append(e)
    launches = {e.correlation_id(): e.start_ns() for e in events
                if e.device_type() != dev and e.correlation_id()}
    ops = [(launches[e.correlation_id()], e.start_ns() + e.duration_ns()) for e in events
           if e.device_type() == dev and not e.name().startswith(ANNOTATION)
           and e.correlation_id() in launches]
    assert ops
    by_name = defaultdict(list)
    for s in spans:
        by_name[s.name].append(s)
    worst_clock = worst_close = 0
    worst_name = None
    for name, group in by_name.items():
        marks = sorted(notes[name], key=lambda e: e.start_ns())
        assert len(marks) == len(group), name
        for s, e in zip(sorted(group, key=lambda s: s.host_open_ns), marks):
            apart = max(abs(e.start_ns() - s.host_open_ns),
                        abs(e.start_ns() + e.duration_ns() - s.host_close_ns))
            if apart > worst_clock:
                worst_clock, worst_name = apart, name
            ends = [end for launch, end in ops if s.host_open_ns <= launch <= s.host_close_ns]
            if ends:
                worst_close = max(worst_close, max(ends) - s.device_close_ns)
    print(f"\nspans {len(spans)}, device ops {len(ops)}: annotation against span host times "
          f"at most {worst_clock / 1e3:.1f} us apart ({worst_name}); last operation's end past the device "
          f"close by at most {worst_close / 1e3:.1f} us")
    assert worst_clock < 1_000_000
    assert worst_close < 1_000_000


def test_trace_generation_allocations_repeat_across_seeds(card):
    """The allocation requests of FqExp's `generate_trace` depend on the
    shapes alone: two seeds, one count."""
    import gc

    from plonky2_bn254_tpu_torch.starks import fq_exp
    from plonky2_bn254_tpu_torch.utils import timing

    counts = []
    for seed in (31, 32):
        gc.collect()
        timing.reset()
        tt = timing.TimingTree(enabled=True)
        fq_exp.generate_trace(_fq_exp_inputs(seed), min_rows=2048)
        counts.append([s.allocs for s in timing.spans() if s.parent is None])
        del tt
    timing.reset()
    print(f"\ngenerate_trace allocation requests, seeds 31 and 32: {counts}")
    assert counts[0] == counts[1] and counts[0][0] > 0


@pytest.mark.parametrize("step", ["double", "mixed_add"])
def test_g1_step_allocations_against_kernel_count(card, step):
    """One G1 chain step on 128 ops: the span's allocation requests beside
    the kernels the profiler counts in it."""
    from plonky2_bn254_tpu_torch.starks import jacobian

    g = torch.Generator().manual_seed(5)
    limbs = [torch.randint(0, 1 << 16, (128, 16), generator=g, dtype=torch.int64).to(card)
             for _ in range(5)]
    run = {"double": lambda: jacobian.double(*limbs[:3]),
           "mixed_add": lambda: jacobian.mixed_add(*limbs)}[step]
    run()  # first-call set-up outside the count
    torch.cuda.synchronize()

    def traced(tt):
        with tt.scope(step):
            run()

    spans, events = _traced(traced)
    (span,) = spans
    kernels = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA
               and not e.name().startswith(("scope:", "warm-up", "Memcpy", "Memset"))]
    print(f"\nG1 {step} step: {span.allocs} allocation requests, {len(kernels)} kernels, "
          f"ratio {span.allocs / len(kernels):.3f}")
    assert len(kernels) > 1000 and 0.5 < span.allocs / len(kernels) < 2.0


# ---------------------------------------------------------------------------
# K5: the quotient's constraint tape (prover/tape.py, csrc/quotient.cu)
# ---------------------------------------------------------------------------

def _tape_machines_on_path():
    import pathlib
    import sys

    here = str(pathlib.Path(__file__).resolve().parent)
    if here not in sys.path:
        sys.path.insert(0, here)


# (machine, coset points at its path key): 2^16 rows at rate 1, the demo
# machines' 2^8, the micro machines' 2^6, the outer proofs' 2^20 and 2^16
K5_PATH_KEYS = [("fq_exp", 1 << 17), ("g1_scalar_mul", 1 << 17), ("g2_scalar_mul", 1 << 17),
                ("demo", 1 << 9), ("keyed_demo", 1 << 9), ("mod_zero", 1 << 7),
                ("g1_add", 1 << 7), ("outer", 1 << 17), ("outer_poseidon", 1 << 17),
                ("outer_circuit2", 1 << 21)]
K5_ODD_SIZE = 1000  # not a multiple of the kernel's 128-thread blocks


@pytest.mark.parametrize("machine, n", K5_PATH_KEYS + [(m, K5_ODD_SIZE) for m, _ in K5_PATH_KEYS])
def test_k5_equals_the_plain_tape(card, machine, n):
    """K5 against the tape run in plain torch, with the next rows read at
    the rate's shift from the LDEs themselves (single device) and from
    aligned next rows (a mesh rank's halo-extended block)."""
    _tape_machines_on_path()
    from plonky2_bn254_tpu_torch.prover import quotient_cuda
    from plonky2_bn254_tpu_torch.prover import tape as tape_mod
    from torch_tape_machines import MACHINES, random_case

    stark = MACHINES[machine]()
    case = random_case(stark, n, seed=n % 97, device=card, as_tensors=True)
    tape = tape_mod.tape_of(stark, 2)
    inputs = tape_mod.scalar_inputs(stark, case["alphas"], case["challenges"], case["totals"],
                                    card)
    args = (tape, case["t_loc"], case["t_loc"], case["a_loc"], case["a_loc"], case["sel"], inputs)
    before = kernels.LAUNCHES["K5"]
    got = quotient_cuda.quotient_values(*args, nxt_shift=2)
    assert kernels.LAUNCHES["K5"] == before + 1
    assert kernels.CALLS["K5"][(stark.width, len(tape.prog), tape.n_slots, n)] >= 1
    assert torch.equal(got, quotient_cuda.quotient_values_plain(*args, nxt_shift=2))
    aligned = (tape, case["t_loc"], case["t_nxt"], case["a_loc"], case["a_nxt"], case["sel"],
               inputs)
    assert torch.equal(quotient_cuda.quotient_values(*aligned),
                       quotient_cuda.quotient_values_plain(*aligned))


def _eager_quotient_on_card(monkeypatch, stark):
    """Swap K5 for the eager GL-ring evaluation the prover ran before it
    (`prove._eager_quotient_values`), on the card, from the same inputs."""
    from plonky2_bn254_tpu_torch.prover import device_challenger as dcm
    from plonky2_bn254_tpu_torch.prover import prove as prove_mod
    from plonky2_bn254_tpu_torch.prover import quotient_cuda

    def eager(tape, t_loc, t_nxt, a_loc, a_nxt, sel, inputs, nxt_shift=0):
        nc = tape.n_out
        t_nxt, a_nxt = (torch.roll(x, -nxt_shift, 1) for x in (t_nxt, a_nxt))
        alphas = list(inputs[:nc])
        challenges = [(inputs[nc + 2 * i], inputs[nc + 2 * i + 1]) for i in range(nc)]
        totals = inputs[3 * nc:].reshape(nc, -1)
        weights = [dcm.ctl_weights_device(stark, b) for b, _ in challenges]
        return prove_mod._eager_quotient_values(stark, t_loc, t_nxt, a_loc, a_nxt, sel, alphas,
                                                challenges, totals, weights)

    monkeypatch.setattr(quotient_cuda, "quotient_values", eager)


def _outer_poseidon_case(card):
    """The outer trace of two chained in-circuit permutations and a gate on
    their output (tests/test_torch_outer.py's Poseidon circuit) at 2^16
    rows."""
    from plonky2_bn254_tpu_torch import circuit as ckt
    from plonky2_bn254_tpu_torch.circuit import outer
    from plonky2_bn254_tpu_torch.circuit import poseidon_gadget as pg

    b = ckt.CircuitBuilder()
    ins = [b.add_virtual_target() for _ in range(12)]
    outs = pg.permute_targets(b, pg.permute_targets(b, ins))
    b.register_public_input(outs[0])
    b.register_public_input(b.mul_add(outs[0], outs[1], outs[2]))
    pw = ckt.Witness()
    for t, v in zip(ins, np.random.default_rng(2024).integers(0, gl.P, size=12, dtype=np.uint64)):
        pw.set_target(t, int(v))
    circuit = b.build()
    data = outer.compile_outer(circuit, 16, device=card)
    trace, _, ctl = outer.build_outer_trace(data, circuit.generate_witness(pw, device=card))
    return data.stark, trace, ctl


@pytest.fixture(scope="module")
def proof_cases():
    """machine -> (stark, trace on the card, CTL values): 128-op G1, FqExp
    and G2 batches drawn as chip_smoke.py draws them, and an outer trace."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels compile and run only on the card)")
    import pathlib
    import sys

    card = torch.device("cuda", 0)
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import chip_smoke

    cases = {}
    for name in ("g1", "fq_exp", "g2"):
        path = chip_smoke.Path(name, card)
        cases[name] = (path.stark, path.trace(), path.ctl_values)
    cases["outer"] = _outer_poseidon_case(card)
    return cases


@pytest.mark.parametrize("device_fs", [True, False])
@pytest.mark.parametrize("machine", ["g1", "fq_exp", "outer"])
def test_k5_proofs_equal_the_eager_quotients(card, proof_cases, monkeypatch, machine,
                                             device_fs):
    """A whole proof with K5 is the proof the eager quotient makes from the
    same trace, field by field, in either transcript; K5 launches once."""
    from plonky2_bn254_tpu_torch.prover import prove as prove_mod
    from plonky2_bn254_tpu_torch.prover.config import DEFAULT_CONFIG

    stark, trace, ctl = proof_cases[machine]
    as_json = lambda p: json.dumps(proof_to_fields(p), default=lambda v: v.tolist())
    kernels.reset_launches()
    with_k5 = as_json(prove_mod.prove(stark, trace, ctl, DEFAULT_CONFIG, device_fs=device_fs))
    assert kernels.LAUNCHES["K5"] == 1
    _eager_quotient_on_card(monkeypatch, stark)
    kernels.reset_launches()
    eager = as_json(prove_mod.prove(stark, trace, ctl, DEFAULT_CONFIG, device_fs=device_fs))
    assert kernels.LAUNCHES["K5"] == 0
    assert with_k5 == eager


def test_k5_rejects_what_it_does_not_take(card):
    """A wrong dtype, a tensor off the card, a wrong shape or a strided view
    raises before any launch."""
    _tape_machines_on_path()
    from plonky2_bn254_tpu_torch.prover import quotient_cuda
    from plonky2_bn254_tpu_torch.prover import tape as tape_mod
    from torch_tape_machines import MACHINES, random_case

    stark = MACHINES["demo"]()
    c = random_case(stark, 64, seed=1, device=card)
    tape = tape_mod.tape_of(stark, 2)
    inputs = tape_mod.scalar_inputs(stark, c["alphas"], c["challenges"], c["totals"], card)
    good = [tape, c["t_loc"], c["t_nxt"], c["a_loc"], c["a_nxt"], c["sel"], inputs]
    bad = {
        "dtype": (1, c["t_loc"].to(torch.int32)),
        "device": (5, c["sel"].cpu()),
        "shape": (3, c["a_loc"][:-1]),
        "inputs": (6, inputs[:-1]),
        "strided": (1, c["t_loc"].repeat(1, 2)[:, ::2]),
    }
    before = kernels.LAUNCHES["K5"]
    for what, (k, x) in bad.items():
        args = list(good)
        args[k] = x
        with pytest.raises(ValueError):
            quotient_cuda.quotient_values(*args)
    assert kernels.LAUNCHES["K5"] == before


# ---------------------------------------------------------------------------
# K6: the batch inverse (field/inv_cuda.py, csrc/inverse.cu)
# ---------------------------------------------------------------------------

# Elements at the keys the paths launch: G2's, G1's and FqExp's range-checked
# columns at 2^16 rows, a table or CTL column (2^16), the FRI oracle's norms
# and the domain's selectors (2^17), the outer proof's 2^20, the CTL totals'
# denominators (2 challenge sets x 2 CTLs x 128 rows); then none, one, either
# side of 1,024 and of a 4,096-element tile, and a prime.
K6_PATH_SIZES = [900 << 16, 450 << 16, 128 << 16, 1 << 16, 1 << 17, 1 << 20, 2 * 2 * 128]
K6_ODD_SIZES = [0, 1, 1023, 1025, 4095, 4097, 10007]


def _with_zeros(n: int, device, seed: int) -> torch.Tensor:
    """Random residues with zeros every 997 elements and at the edges of
    runs (a thread's 16) and tiles (4,096)."""
    x = np.random.default_rng(seed).integers(0, gl.P, size=n, dtype=np.uint64)
    edges = [0, 255, 256, 4095, 4096, 4097, 8191, n - 1] + list(range(5, n, 997))
    x[[e for e in edges if 0 <= e < n]] = 0
    return tensor_from_u64(x, device)


@pytest.mark.parametrize("n", K6_PATH_SIZES + K6_ODD_SIZES)
def test_k6_equals_the_plain_inverse(card, n):
    from plonky2_bn254_tpu_torch.field import inv_cuda

    x = _with_zeros(n, card, seed=n % 101)
    before = kernels.LAUNCHES["K6"]
    got = inv_cuda.batch_inv(x)
    assert kernels.LAUNCHES["K6"] == before + (n > 0)
    assert torch.equal(got, inv_cuda.batch_inv_plain(x))
    if n and n % 2 == 0:  # any shape is one flat vector
        assert torch.equal(inv_cuda.batch_inv(x.reshape(2, -1)), got.reshape(2, -1))


def test_k6_reduces_its_inputs_and_matches_its_emulation(card):
    """Words at or above p are reduced first (p and 0 give 0); the tile the
    kernel reports is the emulation's."""
    from plonky2_bn254_tpu_torch.field import inv_cuda

    assert kernels.library().p2_batch_inverse_block() == inv_cuda.BLOCK
    words = [0, 1, 2, gl.P - 1, gl.P, gl.P + 1, gl.P + 2, 2**64 - 1, 2**63, 2**32]
    x = tensor_from_u64(np.array(words * 500, dtype=np.uint64), card)
    got = inv_cuda.batch_inv(x)
    assert torch.equal(got.cpu(), inv_cuda.emulate(x.cpu()))
    assert [int(v) & (2**64 - 1) for v in got[:len(words)].tolist()] == [
        gl.h_inv(w % gl.P) for w in words]


def test_k6_rejects_what_it_does_not_take(card):
    """A wrong dtype, a strided view or a tensor on neither the card nor the
    host raises before any launch."""
    from plonky2_bn254_tpu_torch.field import inv_cuda

    before = kernels.LAUNCHES["K6"]
    for bad in (torch.ones(64, dtype=torch.int32, device=card),
                torch.ones(64, dtype=torch.int64, device=card)[::2],
                torch.ones(64, dtype=torch.int64, device="meta")):
        with pytest.raises(ValueError):
            inv_cuda.batch_inv(bad)
    assert kernels.LAUNCHES["K6"] == before


@pytest.mark.parametrize("machine", ["g1", "fq_exp", "g2", "outer"])
def test_k6_proofs_equal_the_plain_inverse_proofs(card, proof_cases, monkeypatch, machine):
    """A device-FS proof with K6 is the proof that the plain inverse makes on
    the card from the same trace, field by field; K6 launches once a batch
    inversion of the proof (11 for each batch machine)."""
    import chip_smoke
    from plonky2_bn254_tpu_torch.field import inv_cuda
    from plonky2_bn254_tpu_torch.prover import prove as prove_mod
    from plonky2_bn254_tpu_torch.prover.config import DEFAULT_CONFIG

    stark, trace, ctl = proof_cases[machine]
    as_json = lambda p: json.dumps(proof_to_fields(p), default=lambda v: v.tolist())
    prove_mod.prove(stark, trace, ctl, DEFAULT_CONFIG, device_fs=True)  # caches the domain
    kernels.reset_launches()
    with_k6 = as_json(prove_mod.prove(stark, trace, ctl, DEFAULT_CONFIG, device_fs=True))
    want = chip_smoke.k6_per_proof(stark, DEFAULT_CONFIG.num_challenges, True)
    assert kernels.LAUNCHES["K6"] == want
    if machine != "outer":
        assert want == 11
    monkeypatch.setattr(inv_cuda, "batch_inv", inv_cuda.batch_inv_plain)
    kernels.reset_launches()
    plain = as_json(prove_mod.prove(stark, trace, ctl, DEFAULT_CONFIG, device_fs=True))
    assert kernels.LAUNCHES["K6"] == 0
    assert with_k6 == plain


# ---------------------------------------------------------------------------
# K7: the openings and the FRI oracle (prover/combine_cuda.py, csrc/combine.cu)
# ---------------------------------------------------------------------------

# (k, n) of the openings the paths launch: G2's, G1's and FqExp's trace, aux
# and quotient batches at 2^16 rows, the outer proof's trace and quotient at
# 2^20; then one row, n below a tile, the outer verifier's constant columns
K7_OPENINGS_KEYS = [(1295, 1 << 16), (906, 1 << 16), (781, 1 << 16), (456, 1 << 16),
                    (427, 1 << 16), (134, 1 << 16), (4, 1 << 16), (108, 1 << 20), (4, 1 << 20)]
K7_OPENINGS_ODD = [(1, 1 << 12), (7, 64), (29, 1 << 16)]
# (N, rows of each batch): each machine's oracle over its trace, aux and
# quotient LDEs at 2^17 points, an outer proof's at 2^21; one batch, four
K7_ORACLE_KEYS = [(1 << 17, (1295, 906, 4)), (1 << 17, (781, 456, 4)), (1 << 17, (427, 134, 4)),
                  (1 << 21, (108, 30, 4))]
K7_ORACLE_ODD = [(512, (3,)), (1 << 12, (100, 50, 4, 3))]


def _k7_points(count, device, seed):
    from plonky2_bn254_tpu_torch.field.extension import Ext

    return [Ext(*_rand((2,), device, seed=seed + i)) for i in range(count)]


@pytest.mark.parametrize("k, n", K7_OPENINGS_KEYS + K7_OPENINGS_ODD)
def test_k7_openings_equal_the_plain_version(card, k, n):
    from plonky2_bn254_tpu_torch.prover import combine_cuda
    from plonky2_bn254_tpu_torch.prover import prove as prove_mod

    c = _rand((k, n), card, seed=k + n)
    c[:, -1] = gl.i64(gl.P - 1)
    zs = _k7_points(2, card, seed=k)
    before = kernels.LAUNCHES["K7"]
    got = combine_cuda.openings(c, zs)
    assert kernels.LAUNCHES["K7"] == before + 1
    assert kernels.CALLS["K7"][("openings", k, n)] >= 1
    assert torch.equal(got, torch.stack([prove_mod._openings_plain(c, z) for z in zs]))


def test_k7_mesh_blocks_with_offsets_sum_to_the_whole(card):
    """Rank blocks with `prove._block_offsets`' offsets (a device zeta) add
    up to the whole opening."""
    import types

    from plonky2_bn254_tpu_torch.prover import combine_cuda
    from plonky2_bn254_tpu_torch.prover import prove as prove_mod

    D, k, n = 4, 427, 1 << 16
    c = _rand((k, n), card, seed=3)
    g = gl.primitive_root_of_unity(16)
    zeta = _k7_points(1, card, seed=5)[0]
    zeta_g = prove_mod._times_const(zeta, g)
    total = torch.zeros((2, 2, k), dtype=torch.int64, device=card)
    for r in range(D):
        off = prove_mod._block_offsets(zeta, g, n // D, types.SimpleNamespace(rank=r))
        part = combine_cuda.openings(c[:, r * n // D : (r + 1) * n // D].contiguous(),
                                     (zeta, zeta_g), off)
        total = gl.add(total, part)
    want = torch.stack([prove_mod._openings_plain(c, z) for z in (zeta, zeta_g)])
    assert torch.equal(total, want)


@pytest.mark.parametrize("N, rows", K7_ORACLE_KEYS + K7_ORACLE_ODD)
def test_k7_oracle_equals_the_plain_version(card, N, rows):
    from plonky2_bn254_tpu_torch.prover import combine_cuda
    from plonky2_bn254_tpu_torch.prover import prove as prove_mod

    batches = [_rand((r, N), card, seed=r + i) for i, r in enumerate(rows)]
    batches[0][-1] = gl.i64(gl.P - 1)
    alpha = _rand((sum(rows), 2), card, seed=N % 97)
    zeta, zeta_g, s_zeta, s_zeta_g, alpha_n = _k7_points(5, card, seed=len(rows))
    before = kernels.LAUNCHES["K7"]
    got = combine_cuda.oracle(batches, alpha, (zeta, zeta_g, s_zeta, s_zeta_g, alpha_n))
    assert kernels.LAUNCHES["K7"] == before + 1
    assert kernels.CALLS["K7"][("oracle", N, *rows)] >= 1
    want = prove_mod._fri_oracle_plain(batches, alpha, s_zeta, s_zeta_g, zeta, zeta_g, alpha_n)
    assert torch.equal(got, torch.stack(want))


def test_k7_matches_its_emulations(card):
    """Ragged n and any 64-bit words (which the plain version's add tree
    does not take), and a mesh rank's oracle block: the kernel equals its
    schedule emulated on the CPU with this card's SM count."""
    from plonky2_bn254_tpu_torch.prover import combine_cuda as cc

    sms = cc.sm_count(card)
    assert kernels.library().p2_combine_threads() == cc.THREADS
    assert kernels.library().p2_combine_max_tile() == cc.MAX_TILE
    assert kernels.library().p2_combine_max_batches() == cc.MAX_BATCHES
    for k, n in [(3, 300), (2, 2 * cc.MAX_TILE + 17), (5, 3 * cc.MAX_TILE)]:
        c = _rand((k, n), card, seed=n, full_range=True)
        zs = _k7_points(2, card, seed=n)
        assert torch.equal(cc.openings(c, zs).cpu(),
                           cc.emulate_openings(c.cpu(), [z._replace(c0=z.c0.cpu(), c1=z.c1.cpu())
                                                         for z in zs], sms=sms))
    N, D = 1 << 12, 4
    batches = [_rand((r, N // D), card, seed=r, full_range=True) for r in (150, 60, 4)]
    alpha = _rand((214, 2), card, seed=7)
    scal = _k7_points(5, card, seed=11)
    got = cc.oracle(batches, alpha, scal, x_base=N // D, n_all=N)
    want = cc.emulate_oracle([b.cpu() for b in batches], alpha.cpu(),
                             [z._replace(c0=z.c0.cpu(), c1=z.c1.cpu()) for z in scal],
                             x_base=N // D, n_all=N, sms=sms)
    assert torch.equal(got.cpu(), want)


def test_k7_rejects_what_it_does_not_take(card):
    """A wrong dtype or rank, a strided view, one point or three,
    mismatched batches or alpha rows raise before any launch."""
    from plonky2_bn254_tpu_torch.prover import combine_cuda

    zs = _k7_points(3, card, seed=1)
    c = _rand((4, 256), card)
    before = kernels.LAUNCHES["K7"]
    for bad, pts in ((c.to(torch.int32), zs[:2]), (c[0], zs[:2]), (c[:, ::2], zs[:2]),
                     (c, zs), (c, zs[:1]), (c.cpu(), zs[:2])):
        with pytest.raises(ValueError):
            combine_cuda.openings(bad, pts)
    b = _rand((3, 256), card)
    for batches, alpha in (([b, _rand((2, 128), card)], _rand((5, 2), card)),
                           ([b], _rand((4, 2), card)), ([b] * 5, _rand((15, 2), card))):
        with pytest.raises(ValueError):
            combine_cuda.oracle(batches, alpha, zs[:1] * 5)
    assert kernels.LAUNCHES["K7"] == before


@pytest.mark.parametrize("machine", ["g1", "fq_exp", "g2", "outer"])
def test_k7_proofs_equal_the_plain_proofs(card, proof_cases, monkeypatch, machine):
    """A device-FS proof with K7 is the proof that the plain openings and
    oracle make on the card from the same trace, field by field; K7 runs
    four times a proof (three batches' openings, the oracle)."""
    from plonky2_bn254_tpu_torch.prover import prove as prove_mod
    from plonky2_bn254_tpu_torch.prover.config import DEFAULT_CONFIG

    stark, trace, ctl = proof_cases[machine]
    as_json = lambda p: json.dumps(proof_to_fields(p), default=lambda v: v.tolist())
    kernels.reset_launches()
    with_k7 = as_json(prove_mod.prove(stark, trace, ctl, DEFAULT_CONFIG, device_fs=True))
    assert kernels.LAUNCHES["K7"] == 4
    assert sum(v for key, v in kernels.CALLS["K7"].items() if key[0] == "openings") == 3

    def plain_openings(coeffs, points, mesh=None, offsets=None):
        return torch.stack([prove_mod._openings_plain(coeffs, z, mesh, off)
                            for z, off in zip(points, offsets or (None,) * len(points))])

    monkeypatch.setattr(prove_mod, "_openings", plain_openings)
    monkeypatch.setattr(prove_mod, "_fri_oracle", prove_mod._fri_oracle_plain)
    kernels.reset_launches()
    plain = as_json(prove_mod.prove(stark, trace, ctl, DEFAULT_CONFIG, device_fs=True))
    assert kernels.LAUNCHES["K7"] == 0
    assert with_k7 == plain
