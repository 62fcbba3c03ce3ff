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
from plonky2_bn254_tpu_torch.starks.demo import demo_stark


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
    out["raise_device_fs"] = _raises(lambda: prove_mod.prove(
        demo_stark(), trace, inputs["demo_ctl"], TEST_CONFIG, device_fs=True, mesh=m))

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
    from plonky2_bn254_tpu_torch.starks.demo import demo_trace

    rng = np.random.default_rng(seed)
    trace, ctl = demo_trace(np.random.default_rng(91))
    return {
        "dist_x": rng.integers(0, gl.P, size=(64, 128), dtype=np.uint64),
        "mesh_x": rng.integers(0, gl.P, size=(4, 1024), dtype=np.uint64),
        "col_x": rng.integers(0, gl.P, size=(16, 256), dtype=np.uint64),
        "tree_leaves": rng.integers(0, gl.P, size=(64, 7), dtype=np.uint64),
        "demo_trace": trace.share_memory_(),
        "demo_ctl": ctl,
    }
