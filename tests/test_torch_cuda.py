"""Hand-written CUDA kernels K1-K4 and K2t against their plain PyTorch versions.

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
