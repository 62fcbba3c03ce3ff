"""The rank body of tests/test_torch_parallel.py: everything one rank of a
gloo group on the CPU computes, returned as numpy arrays and python values
for the parent to hold against the JAX package.  Imports no JAX."""

import numpy as np
import torch
import torch.distributed as dist

from plonky2_bn254_tpu_torch import kernels
from plonky2_bn254_tpu_torch.field import ntt_cuda
from plonky2_bn254_tpu_torch.interop import proof_to_fields, tensor_from_u64, u64_from_tensor
from plonky2_bn254_tpu_torch.parallel import mesh as mesh_mod
from plonky2_bn254_tpu_torch.parallel import ntt as pntt
from plonky2_bn254_tpu_torch.prover import prove as prove_mod
from plonky2_bn254_tpu_torch.prover.merkle import sharded_tree
from plonky2_bn254_tpu_torch.prover.config import TEST_CONFIG, StarkConfig
from plonky2_bn254_tpu_torch.starks.demo import demo_stark, keyed_demo_stark


def _raises(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def _no_all_reduce(*args, **kwargs):
    raise AssertionError("a collective summed with all_reduce")


def rank_case(rank: int, world: int, inputs: dict) -> dict:
    """Run every check of the parallel tests on this rank of a CPU mesh."""
    torch.set_num_threads(1)
    dist.all_reduce = _no_all_reduce  # field sums must be gathered and added mod p
    m = mesh_mod.make_mesh(world, device="cpu")
    u64 = lambda t: u64_from_tensor(t)
    out = {"rank": m.rank, "size": m.size, "backend": m.backend}

    x = tensor_from_u64(inputs["dist_x"])  # [64, 128]
    out["distributed_ntt"] = u64(pntt.distributed_ntt(mesh_mod.shard_cols(m, x), m))

    v = tensor_from_u64(inputs["mesh_x"])  # [4, 1024]
    blk = mesh_mod.shard_cols(m, v)
    out["mesh_ntt"] = u64(pntt.mesh_ntt(blk, m))
    out["mesh_intt"] = u64(pntt.mesh_intt(blk, m))
    out["mesh_lde"] = u64(pntt.mesh_coset_lde_rate1(blk, m))

    cols = mesh_mod.shard_rows(m, tensor_from_u64(inputs["col_x"]))  # [16 / D, 256]
    out["col_lde"] = u64(ntt_cuda.coset_lde(ntt_cuda.intt(cols), 1))

    # a sharded tree of 64 leaves at cap heights below, at and above log2 D
    leaves = mesh_mod.shard_rows(m, tensor_from_u64(inputs["tree_leaves"]))
    every_leaf = torch.arange(inputs["tree_leaves"].shape[0])
    out["trees"] = {}
    for cap_height in range(4):
        tree = sharded_tree(leaves, cap_height, m)
        out["trees"][cap_height] = (u64(tree.cap), [u64(p) for p in tree.paths(every_leaf, m)])

    # shapes the mesh functions refuse, before any collective
    small = mesh_mod.shard_cols(m, v[:, :world])  # N = D: not a multiple of D^2
    out["raise_n_mod_d2"] = _raises(lambda: pntt.mesh_ntt(small, m))
    trace = inputs["demo_trace"]
    out["raise_rate"] = _raises(lambda: prove_mod.prove(
        demo_stark(), trace, inputs["demo_ctl"], StarkConfig(rate_bits=2, cap_height=1), mesh=m))

    # the demo proof, recording the shape of every commit's LDE
    lde_shapes = []
    commit_values, commit_coeffs = prove_mod.commit_values, prove_mod.commit_coeffs

    def rec_values(*a, **k):
        res = commit_values(*a, **k)
        lde_shapes.append(tuple(res[1].shape))
        return res

    def rec_coeffs(*a, **k):
        res = commit_coeffs(*a, **k)
        lde_shapes.append(tuple(res[0].shape))
        return res

    prove_mod.commit_values, prove_mod.commit_coeffs = rec_values, rec_coeffs
    m.reset_stats()
    try:
        proof = prove_mod.prove(demo_stark(), trace, inputs["demo_ctl"], TEST_CONFIG, mesh=m)
    finally:
        prove_mod.commit_values, prove_mod.commit_coeffs = commit_values, commit_coeffs
    out["proof"] = proof_to_fields(proof)
    out["lde_shapes"] = lde_shapes
    out["stats"] = dict(m.stats)
    out["device_fs_proof"] = proof_to_fields(prove_mod.prove(
        demo_stark(), trace, inputs["demo_ctl"], TEST_CONFIG, device_fs=True, mesh=m))
    if world == 4:
        out["mesh2d"] = mesh2d_case(rank, inputs)
    return out


def _record_trace_blocks(blocks: list):
    """Wrap `prove_mod.commit_trace` to record the shape of the trace block
    it is given; returns the function that undoes the wrap."""
    commit_trace = prove_mod.commit_trace

    def rec(values, *a, **k):
        blocks.append(tuple(values.shape))
        return commit_trace(values, *a, **k)

    prove_mod.commit_trace = rec
    return lambda: setattr(prove_mod, "commit_trace", commit_trace)


# (machine, prove keywords) of each 2-D case on the (2, 2) mesh over ("tp", "dp")
MESH2D_CASES = {
    "rows_tp_dp": ("demo", {"mesh_axis": ("tp", "dp")}),
    # the flattened axes in the other order than the mesh's
    "rows_dp_tp": ("demo", {"mesh_axis": ("dp", "tp")}),
    "rows_tp_dp_device_fs": ("demo", {"mesh_axis": ("tp", "dp"), "device_fs": True}),
    # width 5 does not divide over tp: the columns replicate
    "cols_replicated": ("demo", {"mesh_axis": "dp", "col_axis": "tp"}),
    # width 6 does: each rank commits [3, n/2] of the trace
    "keyed_cols_sharded": ("keyed", {"mesh_axis": "dp", "col_axis": "tp"}),
    "keyed_cols_sharded_device_fs": ("keyed", {"mesh_axis": "dp", "col_axis": "tp",
                                               "device_fs": True}),
}


def mesh2d_case(rank: int, inputs: dict) -> dict:
    """On 4 ranks: the (2, 2) mesh's layout and its reversed-order
    collectives, then every MESH2D_CASES proof with the trace block each
    rank committed and the bytes it sent over each axis."""
    raise_shape = _raises(lambda: mesh_mod.make_mesh2d((3, 2), device="cpu"))
    m2 = mesh_mod.make_mesh2d((2, 2), device="cpu")
    flat = {axes: m2.sub(axes) for axes in (("tp", "dp"), ("dp", "tp"))}
    rev = flat[("dp", "tp")]
    pieces = [torch.tensor([10 * rev.rank + t]) for t in range(4)]
    out = {"coords": m2.coords, "raise_shape": raise_shape,
           "subs": {",".join(k): (m.rank, m.size) for k, m in m2.meshes.items()},
           "rev_exchange": [int(x) for x in mesh_mod.exchange(rev, pieces, [(1,)] * 4)],
           "rev_gather": u64_from_tensor(mesh_mod.all_gather(rev, torch.tensor([rev.rank]))),
           "raise_col_in_rows": _raises(lambda: prove_mod.prove(
               demo_stark(), inputs["demo_trace"], inputs["demo_ctl"], TEST_CONFIG, mesh=m2,
               mesh_axis=("tp", "dp"), col_axis="tp")),
           "proofs": {}}
    machines = {"demo": (demo_stark(), inputs["demo_trace"], inputs["demo_ctl"]),
                "keyed": (keyed_demo_stark(), inputs["keyed_trace"], inputs["keyed_ctl"])}
    for name, (machine, kw) in MESH2D_CASES.items():
        stark, trace, ctl = machines[machine]
        blocks = []
        undo = _record_trace_blocks(blocks)
        m2.reset_stats()
        try:
            proof = prove_mod.prove(stark, trace, ctl, TEST_CONFIG, mesh=m2, **kw)
        finally:
            undo()
        out["proofs"][name] = {"proof": proof_to_fields(proof), "trace_blocks": blocks,
                               "stats": m2.stats}
    return out


def card_rank_case(rank: int, world: int, x: np.ndarray) -> dict:
    """On the card: this rank's blocks of the three mesh transforms of `x`
    and of `distributed_ntt` of its [64, -1] view (the mesh on the default
    device, cuda:0 for every rank of one card), its K3 launches, and where
    its blocks lived and travelled."""
    m = mesh_mod.make_mesh(world)
    blk = mesh_mod.shard_cols(m, tensor_from_u64(x))
    kernels.reset_launches()
    out = {"mesh_ntt": pntt.mesh_ntt(blk, m), "mesh_intt": pntt.mesh_intt(blk, m),
           "mesh_lde": pntt.mesh_coset_lde_rate1(blk, m),
           "distributed_ntt": pntt.distributed_ntt(mesh_mod.shard_cols(m, tensor_from_u64(
               x.reshape(64, -1))), m)}
    return {"device": str(blk.device), "wire": str(m.wire), "K3": kernels.LAUNCHES["K3"],
            **{k: u64_from_tensor(v) for k, v in out.items()}}


def card_mesh_prove_case(rank: int, world: int, inputs: dict) -> dict:
    """On the card (4 ranks): the demo proved with the device transcript on
    the 1-D mesh and with the rows over ("tp", "dp") of the (2, 2) mesh,
    each with this rank's launches."""
    m1, m2 = mesh_mod.make_mesh(world), mesh_mod.make_mesh2d((2, 2))
    args = (demo_stark(), inputs["demo_trace"], inputs["demo_ctl"], TEST_CONFIG)
    out = {}
    for name, kw in (("device_fs_1d", {"mesh": m1, "device_fs": True}),
                     ("rows_tp_dp", {"mesh": m2, "mesh_axis": ("tp", "dp")})):
        kernels.reset_launches()
        out[name] = {"proof": proof_to_fields(prove_mod.prove(*args, **kw)),
                     "launches": dict(kernels.LAUNCHES)}
    return out


def nccl_rank_case(rank: int, world: int) -> None:
    """make_mesh on an NCCL group: raises where the ranks share a card."""
    mesh_mod.make_mesh(world)


def fail_on_rank_1(rank: int, world: int) -> int:
    if rank == 1:
        raise ValueError("rank 1 refuses")
    return rank


def demo_inputs(seed: int) -> dict:
    """The inputs every rank gets: random residues for the transforms and
    the demo machine's trace (a CPU tensor, shared with the ranks)."""
    from plonky2_bn254_tpu_torch.field import goldilocks as gl
    from plonky2_bn254_tpu_torch.starks.demo import demo_trace, keyed_demo_trace

    rng = np.random.default_rng(seed)
    trace, ctl = demo_trace(np.random.default_rng(91))
    keyed, keyed_ctl = keyed_demo_trace(np.random.default_rng(21))
    return {
        "dist_x": rng.integers(0, gl.P, size=(64, 128), dtype=np.uint64),
        "mesh_x": rng.integers(0, gl.P, size=(4, 1024), dtype=np.uint64),
        "col_x": rng.integers(0, gl.P, size=(16, 256), dtype=np.uint64),
        "tree_leaves": rng.integers(0, gl.P, size=(64, 7), dtype=np.uint64),
        "demo_trace": trace.share_memory_(),
        "demo_ctl": ctl,
        "keyed_trace": keyed.share_memory_(),
        "keyed_ctl": keyed_ctl,
    }


def mesh2d_8_case(rank: int, world: int, inputs: dict) -> dict:
    """On 8 ranks: the demo proved with rows over ("tp", "dp") of
    make_mesh2d((2, 4)), and over ("dp", "tp") of a (2, 4) mesh whose axes
    are ("dp", "tp")."""
    torch.set_num_threads(1)
    args = (demo_stark(), inputs["demo_trace"], inputs["demo_ctl"], TEST_CONFIG)
    out = {}
    for axes in (("tp", "dp"), ("dp", "tp")):
        m2 = mesh_mod.make_mesh2d((2, 4), axes=axes, device="cpu")
        out[axes] = proof_to_fields(prove_mod.prove(*args, mesh=m2, mesh_axis=axes))
    return out
