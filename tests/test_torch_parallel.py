"""The port's multi-device prover (`plonky2_bn254_tpu_torch/parallel/`) on 2
and 4 gloo ranks on the CPU against the JAX package: the twins of
tests/test_parallel.py, tolerance 0 everywhere (exact mod-p arithmetic and a
deterministic transcript).

Each world size spawns its ranks once (`parallel/launch.py`); every rank
runs `torch_parallel_case.rank_case` and returns its blocks and its proof,
and the JAX references are computed here while the ranks run.
"""

import pathlib
import re
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky2_bn254_tpu.field import ntt as jntt
from plonky2_bn254_tpu.parallel import mesh as jmesh
from plonky2_bn254_tpu.parallel import ntt as jpntt
from plonky2_bn254_tpu.prover import prove as jprove
from plonky2_bn254_tpu.prover import verify as jverify
from plonky2_bn254_tpu.prover.config import TEST_CONFIG as JTEST_CONFIG
from plonky2_bn254_tpu.starks import demo as jdemo
from plonky2_bn254_tpu_torch.interop import proof_from_fields, proof_to_fields, tensor_from_u64
from plonky2_bn254_tpu_torch.parallel import launch
from plonky2_bn254_tpu_torch.parallel import mesh as mesh_mod
from plonky2_bn254_tpu_torch.parallel import ntt as pntt
from plonky2_bn254_tpu_torch.prover import prove as prove_mod
from plonky2_bn254_tpu_torch.prover import verify as verify_mod
from plonky2_bn254_tpu_torch.prover.config import TEST_CONFIG
from plonky2_bn254_tpu_torch.prover.merkle import device_tree_levels, gather_paths_dev
from plonky2_bn254_tpu_torch.starks.demo import demo_stark
from test_torch_prove import assert_fields_equal, to_jax_proof
from torch_parallel_case import demo_inputs, fail_on_rank_1, rank_case

torch.set_num_threads(2)

WORLDS = (2, 4)
SEED = 61
RANK_TIMEOUT_S = 600


def _jax_refs(inputs) -> dict:
    """The JAX package's transforms (single device, and its own mesh
    transforms on a D-device CPU mesh) and its demo proof."""
    x = jnp.asarray(inputs["mesh_x"])
    refs = {
        "single_device_reference": np.asarray(
            jpntt.single_device_reference(jnp.asarray(inputs["dist_x"]))),
        "ntt": np.asarray(jntt.ntt(x)),
        "intt": np.asarray(jntt.intt(x)),
        "lde": np.asarray(jntt.coset_lde_from_coeffs(x, 1)),
        "col_lde": np.asarray(jntt.coset_lde(jnp.asarray(inputs["col_x"]), 1)),
        "mesh": {},
    }
    for D in WORLDS:
        m = jmesh.make_mesh(D, devices=jax.local_devices(backend="cpu"))
        refs["mesh"][D] = {
            name: np.asarray(jax.jit(lambda v, fn=fn: fn(v, m))(x))
            for name, fn in (("mesh_ntt", jpntt.mesh_ntt), ("mesh_intt", jpntt.mesh_intt),
                             ("mesh_lde", jpntt.mesh_coset_lde_rate1))
        }
    jtrace, jctl = jdemo.demo_trace(np.random.default_rng(91))
    np.testing.assert_array_equal(np.asarray(jtrace), inputs["demo_trace"].numpy().view(np.uint64))
    refs["jax_proof"] = proof_to_fields(
        jprove.prove(jdemo.demo_stark(), jtrace, jctl, JTEST_CONFIG))
    return refs


@pytest.fixture(scope="module")
def runs():
    """(inputs, JAX references, the port's single-device demo proof,
    {D: every rank's results}): both worlds run while JAX computes."""
    inputs = demo_inputs(SEED)
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        futures = {D: pool.submit(launch.run, rank_case, D, inputs, timeout=RANK_TIMEOUT_S)
                   for D in WORLDS}
        refs = _jax_refs(inputs)
        single = proof_to_fields(prove_mod.prove(
            demo_stark(), inputs["demo_trace"], inputs["demo_ctl"], TEST_CONFIG))
        worlds = {D: f.result() for D, f in futures.items()}
    return inputs, refs, single, worlds


def _cat(results, key, axis):
    return np.concatenate([r[key] for r in results], axis=axis)


@pytest.mark.parametrize("D", WORLDS)
def test_ranks_form_the_mesh(runs, D):
    results = runs[3][D]
    assert [(r["rank"], r["size"], r["backend"]) for r in results] == [
        (i, D, "gloo") for i in range(D)]


@pytest.mark.parametrize("D", WORLDS)
def test_distributed_ntt_matches_single_device(runs, D):
    inputs, refs, _, worlds = runs
    assert all(r["distributed_ntt"].shape == (64 // D, 128) for r in worlds[D])
    np.testing.assert_array_equal(_cat(worlds[D], "distributed_ntt", 0),
                                  refs["single_device_reference"])


@pytest.mark.parametrize("D", WORLDS)
def test_mesh_ntt_natural_bit_identity(runs, D):
    """mesh_ntt / mesh_intt / mesh_coset_lde_rate1 keep the natural layout
    (each rank a contiguous block) and equal JAX's single-device transforms
    and JAX's own mesh transforms on D devices."""
    _, refs, _, worlds = runs
    for key, single, blk in (("mesh_ntt", "ntt", 1024), ("mesh_intt", "intt", 1024),
                             ("mesh_lde", "lde", 2048)):
        assert all(r[key].shape == (4, blk // D) for r in worlds[D]), key
        got = _cat(worlds[D], key, 1)
        np.testing.assert_array_equal(got, refs[single], err_msg=key)
        np.testing.assert_array_equal(got, refs["mesh"][D][key], err_msg=key)


@pytest.mark.parametrize("D", WORLDS)
def test_sharded_column_commit(runs, D):
    """Column-sharded rate-1 LDE: each rank extends its own polynomials."""
    _, refs, _, worlds = runs
    assert all(r["col_lde"].shape == (16 // D, 512) for r in worlds[D])
    np.testing.assert_array_equal(_cat(worlds[D], "col_lde", 0), refs["col_lde"])


@pytest.mark.parametrize("D", WORLDS)
def test_sharded_tree_matches_single_device(runs, D):
    """Caps and Merkle paths of a tree over 64 leaves split over D ranks,
    at cap heights below (the subtree roots gathered, levels built above
    them), at and above log2 D (the cap inside the subtrees)."""
    inputs, _, _, worlds = runs
    leaves = tensor_from_u64(inputs["tree_leaves"])
    every_leaf = torch.arange(leaves.shape[0])
    for cap_height in range(4):
        levels = device_tree_levels(leaves, cap_height)
        want_paths = [p.numpy().view(np.uint64) for p in gather_paths_dev(levels, every_leaf)]
        for r in worlds[D]:
            cap, paths = r["trees"][cap_height]
            np.testing.assert_array_equal(cap, levels[-1].numpy().view(np.uint64))
            assert len(paths) == len(want_paths)
            for got, want in zip(paths, want_paths):
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("D", WORLDS)
def test_mesh_prove_matches_single_device(runs, D):
    """The demo machine at TEST_CONFIG (256 rows, cap height 1: equal to
    log2 D at D = 2, below it at D = 4) proved on D ranks: every rank's
    proof equals the port's single-device proof and JAX's field by field,
    and both verifiers accept it."""
    inputs, refs, single, worlds = runs
    for r in worlds[D]:
        assert_fields_equal(r["proof"], single)
        assert_fields_equal(r["proof"], refs["jax_proof"])
    fields = worlds[D][0]["proof"]
    verify_mod.verify(demo_stark(), proof_from_fields(fields), inputs["demo_ctl"], TEST_CONFIG)
    jverify.verify(jdemo.demo_stark(), to_jax_proof(fields), inputs["demo_ctl"], JTEST_CONFIG)


@pytest.mark.parametrize("D", WORLDS)
def test_each_rank_holds_its_block(runs, D):
    """Every commit leaves [w, N/D] on each rank (trace, aux, quotient), and
    no collective gathers a whole [w, N] batch (the largest gather is a
    Merkle-path or FRI-column gather, below the narrowest batch)."""
    _, _, single, worlds = runs
    N = 2 << single["degree_bits"]
    for r in worlds[D]:
        assert [s[1] for s in r["lde_shapes"]] == [N // D] * 3
        narrowest = min(s[0] for s in r["lde_shapes"])
        assert r["stats"]["largest_gather_words"] < narrowest * N
        assert r["stats"]["exchanges"] > 0 and r["stats"]["bytes_sent"] > 0


@pytest.mark.parametrize("D", WORLDS)
def test_mesh_refuses_what_it_cannot_shard(runs, D):
    """N not a multiple of D^2, a rate other than 1, and device FS raise on
    every rank before any collective."""
    for r in runs[3][D]:
        assert "multiple of D^2" in r["raise_n_mod_d2"]
        assert "rate_bits = 1" in r["raise_rate"]
        assert "device_fs=True" in r["raise_device_fs"]


def test_field_sums_never_use_all_reduce(runs):
    """The ranks ran every check with `dist.all_reduce` replaced by a raise
    (`rank_case`), and no module of the mesh path calls it."""
    assert set(runs[3]) == set(WORLDS)
    port = pathlib.Path(pntt.__file__).resolve().parent.parent
    for path in [*(port / "parallel").glob("*.py"), *(port / "prover").glob("*.py")]:
        assert not re.search(r"all_reduce\s*\(", path.read_text()), path


def test_rank_tables_equal_jax_rows(runs):
    """Each rank's device tables are its rows and slices of JAX's tables."""
    for D in WORLDS:
        d_log = D.bit_length() - 1
        for inverse in (False, True):
            for rank in range(D):
                M, tw = pntt._rank_tables(10, d_log, inverse, rank, torch.device("cpu"))
                np.testing.assert_array_equal(M.numpy().view(np.uint64),
                                              jpntt._dftD_matrix(10, d_log, inverse))
                np.testing.assert_array_equal(tw.numpy().view(np.uint64),
                                              jpntt._mid_twiddle(10, d_log, inverse)[rank])
        pre = np.asarray(jntt._coset_powers(1024, 7))
        got = [pntt._rank_coset(1024, 7, r, 1024 // D, torch.device("cpu")) for r in range(D)]
        np.testing.assert_array_equal(np.concatenate([g.numpy().view(np.uint64) for g in got]), pre)


def test_make_mesh_needs_an_initialised_group():
    with pytest.raises(RuntimeError, match="not initialised"):
        mesh_mod.make_mesh(2, device="cpu")


def test_launch_reports_a_failed_rank():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        launch.run(fail_on_rank_1, 2, timeout=120)
