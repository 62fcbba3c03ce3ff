"""The port's multi-device prover (`plonky2_bn254_tpu_torch/parallel/`) on 2
and 4 gloo ranks on the CPU against the JAX package: the twins of
tests/test_parallel.py, tolerance 0 everywhere (exact mod-p arithmetic and a
deterministic transcript).

Each world size spawns its ranks once (`parallel/launch.py`); every rank
runs `torch_parallel_case.rank_case` and returns its blocks and its proofs
(host and device transcript; the 4-rank world also on a (2, 2) mesh), and
the JAX references are computed here while the ranks run.  The (2, 4)
8-rank twins and the production FqExp proof on a 2-D mesh are slow-tier.
"""

import pathlib
import re
import subprocess
import sys
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
from plonky2_bn254_tpu_torch.starks.demo import demo_stark, keyed_demo_stark
from test_torch_prove import assert_fields_equal, to_jax_proof
from torch_parallel_case import (MESH2D_CASES, demo_inputs, fail_on_rank_1, mesh2d_8_case,
                                 rank_case)

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
    jkeyed, jkctl = jdemo.keyed_demo_trace(np.random.default_rng(21))
    refs["jax_keyed_proof"] = proof_to_fields(
        jprove.prove(jdemo.keyed_demo_stark(), jkeyed, jkctl, JTEST_CONFIG))
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
        refs["keyed_single"] = proof_to_fields(prove_mod.prove(
            keyed_demo_stark(), inputs["keyed_trace"], inputs["keyed_ctl"], TEST_CONFIG))
        worlds = {D: f.result() for D, f in futures.items()}
    return inputs, refs, single, worlds


def _machine(name, inputs):
    """(port stark, JAX stark, CTL values) of the demo or keyed machine."""
    if name == "demo":
        return demo_stark(), jdemo.demo_stark(), inputs["demo_ctl"]
    return keyed_demo_stark(), jdemo.keyed_demo_stark(), inputs["keyed_ctl"]


def _assert_proof_is_the_single_device_one(fields_per_rank, port_single, jax_single, machine,
                                           inputs):
    """Every rank's proof equals the port's and JAX's single-device proofs
    field by field, and both verifiers accept it."""
    for fields in fields_per_rank:
        assert_fields_equal(fields, port_single)
        assert_fields_equal(fields, jax_single)
    stark, jstark, ctl = _machine(machine, inputs)
    verify_mod.verify(stark, proof_from_fields(fields_per_rank[0]), ctl, TEST_CONFIG)
    jverify.verify(jstark, to_jax_proof(fields_per_rank[0]), ctl, JTEST_CONFIG)


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
def test_mesh_device_fs_proof_matches_single_device(runs, D):
    """prove(mesh=..., device_fs=True): every rank runs its own device
    challenger on the gathered caps, and its proof is the single-device one
    (port and JAX), which both verifiers accept."""
    inputs, refs, single, worlds = runs
    _assert_proof_is_the_single_device_one([r["device_fs_proof"] for r in worlds[D]], single,
                                           refs["jax_proof"], "demo", inputs)


def test_mesh2d_layout(runs):
    """make_mesh2d((2, 2)) over ("tp", "dp"): rank r at (r // 2, r % 2); the
    sub-mesh along tp / dp ranks by that coordinate; the flattened meshes
    rank tp * 2 + dp and dp * 2 + tp; on the ("dp", "tp") one, whose block
    order differs from the group's, an exchange sends piece t to block t
    and a gather returns the blocks in block order."""
    for r, res in enumerate(runs[3][4]):
        tp, dp = r // 2, r % 2
        m = res["mesh2d"]
        assert tuple(m["coords"]) == (tp, dp)
        assert m["subs"] == {"tp": (tp, 2), "dp": (dp, 2), "tp,dp": (2 * tp + dp, 4),
                             "dp,tp": (2 * dp + tp, 4)}
        block = 2 * dp + tp
        assert m["rev_exchange"] == [10 * s + block for s in range(4)]
        assert list(m["rev_gather"]) == [0, 1, 2, 3]
        assert "split over" in m["raise_col_in_rows"]
        assert "needs 6 ranks" in m["raise_shape"]


@pytest.mark.parametrize("case", list(MESH2D_CASES))
def test_mesh2d_prove_matches_single_device(runs, case):
    """The demo and keyed_demo machines on the (2, 2) mesh: rows over both
    axes in either order, the columns over tp (replicated for the demo's 5,
    sharded for keyed_demo's 6), each transcript: every rank's proof is the
    single-device one (port and JAX), which both verifiers accept."""
    inputs, refs, single, worlds = runs
    machine = MESH2D_CASES[case][0]
    port_single, jax_single = ((single, refs["jax_proof"]) if machine == "demo"
                               else (refs["keyed_single"], refs["jax_keyed_proof"]))
    _assert_proof_is_the_single_device_one(
        [r["mesh2d"]["proofs"][case]["proof"] for r in worlds[4]], port_single, jax_single,
        machine, inputs)


def test_col_axis_shards_the_trace_commit(runs):
    """With col_axis="tp" each rank commits [w / 2, n / 2] of keyed_demo's
    trace and gathers the other column block over tp (bytes on the tp
    sub-mesh); the demo's 5 columns do not split over 2, so each rank
    commits [5, n / 2] and sends nothing over tp."""
    n = 256
    for r in runs[3][4]:
        proofs = r["mesh2d"]["proofs"]
        for case in ("keyed_cols_sharded", "keyed_cols_sharded_device_fs"):
            assert proofs[case]["trace_blocks"] == [(3, n // 2)]
            tp = proofs[case]["stats"]["by_axes"]["tp"]
            # one gather of the values, coefficients and LDE: [3, 4 n / 2] words
            assert (tp["gathers"], tp["bytes_sent"]) == (1, 8 * 3 * 4 * (n // 2))
        assert proofs["cols_replicated"]["trace_blocks"] == [(5, n // 2)]
        assert proofs["cols_replicated"]["stats"]["by_axes"]["tp"]["bytes_sent"] == 0
        rows = proofs["rows_tp_dp"]["stats"]["by_axes"]
        assert rows["tp,dp"]["bytes_sent"] > 0 and rows["tp"]["bytes_sent"] == 0


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
    """N not a multiple of D^2 and a rate other than 1 raise on every rank
    before any collective."""
    for r in runs[3][D]:
        assert "multiple of D^2" in r["raise_n_mod_d2"]
        assert "rate_bits = 1" in r["raise_rate"]


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
    with pytest.raises(RuntimeError, match="not initialised"):
        mesh_mod.make_mesh2d((2, 2), device="cpu")


def test_prove_refuses_mesh_axes_without_a_mesh():
    """mesh_axis / col_axis without a mesh, or naming an axis a 1-D mesh
    lacks, raise before anything is proved."""
    inputs = demo_inputs(SEED)
    args = (demo_stark(), inputs["demo_trace"], inputs["demo_ctl"], TEST_CONFIG)
    with pytest.raises(ValueError, match="need a mesh"):
        prove_mod.prove(*args, col_axis="tp")
    one_d = mesh_mod.Mesh(group=None, rank=0, size=2, axis="dp", device=torch.device("cpu"),
                          backend="gloo")
    with pytest.raises(ValueError, match="has no axis"):
        prove_mod.prove(*args, mesh=one_d, mesh_axis="tp")


def test_launch_reports_a_failed_rank():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        launch.run(fail_on_rank_1, 2, timeout=120)


@pytest.mark.slow
def test_mesh2d_8_ranks_matches_single_device():
    """The (2, 4) twin of tests/test_parallel.py's 2-D cases on 8 gloo
    ranks: the demo with rows over ("tp", "dp") of make_mesh2d((2, 4)), and
    over ("dp", "tp") of a mesh whose axes are ("dp", "tp"); every rank's
    proof equals the single-device ones of the port and JAX."""
    inputs = demo_inputs(SEED)
    ranks = launch.run(mesh2d_8_case, 8, inputs, timeout=RANK_TIMEOUT_S)
    jtrace, jctl = jdemo.demo_trace(np.random.default_rng(91))
    jax_proof = proof_to_fields(jprove.prove(jdemo.demo_stark(), jtrace, jctl, JTEST_CONFIG))
    single = proof_to_fields(prove_mod.prove(
        demo_stark(), inputs["demo_trace"], inputs["demo_ctl"], TEST_CONFIG))
    for case in ranks[0]:
        _assert_proof_is_the_single_device_one([r[case] for r in ranks], single, jax_proof,
                                               "demo", inputs)


@pytest.mark.slow
def test_mesh2d_production_fq_exp_on_the_cpu():
    """scripts/torch_mesh2d_production.py on the CPU: the FqExp 2^16 x 427
    trace on a (2, 4) mesh of gloo ranks, rows over both axes; it exits 0
    only if the proof verifies and equals the single-device proof."""
    root = pathlib.Path(__file__).resolve().parent.parent
    done = subprocess.run([sys.executable, "scripts/torch_mesh2d_production.py", "--device", "cpu"],
                          cwd=root, capture_output=True, text=True, timeout=3000)
    assert done.returncode == 0, done.stdout[-4000:] + done.stderr[-4000:]
    assert "bit-identical" in done.stdout
