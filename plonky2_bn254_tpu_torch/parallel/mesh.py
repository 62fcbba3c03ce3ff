"""1-D and 2-D meshes of torch.distributed ranks and the collectives the
sharded prover uses.

Port of `plonky2_bn254_tpu/parallel/mesh.py`.  The JAX package shards
arrays over a `jax.sharding.Mesh` and lets shard_map or GSPMD insert the
collectives.  Here every rank is one process (SPMD): it holds only its own
block of a sharded axis and calls the collectives itself.  A 2-D mesh
(`make_mesh2d`) hands out 1-D meshes: the sub-group along one axis, or all
ranks flattened over an ordered pair of axes.

  shard_rows / shard_cols   this rank's contiguous block of axis 0 / 1
  replicated                the whole tensor on this rank's device
  all_to_all                `lax.all_to_all`'s semantics (split_axis,
                            concat_axis, tiled), on `dist.all_to_all_single`
  all_gather                every rank's block, concatenated along an axis
  exchange                  one piece of any size to each rank (the
                            reshards all_to_all cannot express)

The transport follows the group's backend, read once in `make_mesh`: NCCL
moves the rank's device tensors, gloo moves host tensors (a CUDA block is
copied to the host before an exchange and back after it).  Residues are
int64; no collective here adds them, since a SUM by `dist.all_reduce` would add
mod 2^64, not mod p: callers gather partial sums and add them with `gl.add`.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


@dataclass
class Mesh:
    """This rank's view of a 1-D mesh: its process group, its block index
    (`rank`) and the mesh size, the axis name, the device its blocks live
    on, and the device its exchanges go through.  `order[t]`, where given,
    is the group rank that holds block t (a flattened 2-D mesh whose axes
    run in another order than the group's ranks); None: block t is group
    rank t.  `stats` counts what this rank sent."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    axis: str
    device: torch.device
    backend: str
    order: Optional[List[int]] = None
    stats: dict = field(default_factory=lambda: {
        "bytes_sent": 0, "exchanges": 0, "gathers": 0, "largest_gather_words": 0})

    @property
    def wire(self) -> torch.device:
        """Where tensors travel: the rank's device for NCCL, the host for gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def reset_stats(self) -> None:
        for k in self.stats:
            self.stats[k] = 0


def _default_device(rank: int) -> torch.device:
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' to run on the host")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local_rank % count)


def _check_nccl_devices(group, device: torch.device) -> None:
    """NCCL cannot put two ranks of one communicator on one card: raise
    before any NCCL collective runs (a side gloo group carries the check)."""
    if device.type != "cuda":
        raise ValueError(f"make_mesh: an NCCL group needs CUDA devices, got {device}")
    ranks = dist.get_process_group_ranks(group) if group is not None else list(
        range(dist.get_world_size()))
    side = dist.new_group(ranks, backend="gloo")
    keys: List = [None] * len(ranks)
    dist.all_gather_object(keys, (socket.gethostname(), device.index), group=side)
    dist.destroy_process_group(side)
    if len(set(keys)) != len(keys):
        raise ValueError(f"make_mesh: NCCL ranks share a card ((host, device) per rank: {keys}); "
                         "give each rank its own card or use a gloo group")


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp", device=None,
              group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """This rank's mesh over an initialised process group (the default
    group unless `group` is given; the caller owns `init_process_group`).
    `n_devices`, if given, must equal the group's size.  `device`: where
    this rank's blocks live; default `cuda:{LOCAL_RANK % device_count}`,
    or "cpu" when the caller asks."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised "
                           "(call init_process_group first)")
    size = dist.get_world_size(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh: n_devices={n_devices} but the group has {size} ranks")
    rank = dist.get_rank(group)
    backend = str(dist.get_backend(group))
    if backend not in BACKENDS:
        raise ValueError(f"make_mesh: backend {backend!r} is not one of {BACKENDS}")
    device = _default_device(rank) if device is None else torch.device(device)
    if backend == "nccl":
        _check_nccl_devices(group, device)
    return Mesh(group=group, rank=rank, size=size, axis=axis, device=device, backend=backend)


@dataclass
class Mesh2D:
    """This rank's view of a 2-D mesh of `shape` over `axes`: the group's
    ranks laid out row-major, rank r at (r // shape[1], r % shape[1]), as
    the JAX package's `np.array(devices).reshape(shape)`.  `sub` gives its
    1-D meshes: one axis name -> this rank's sub-group along that axis; an
    ordered pair of axes -> every rank, its block index the number its
    coordinates spell in that order (("tp", "dp") on (2, 4): tp * 4 + dp)."""

    shape: Tuple[int, int]
    axes: Tuple[str, str]
    coords: Tuple[int, int]
    device: torch.device
    meshes: Dict[Tuple[str, ...], Mesh]

    def sub(self, axes) -> Mesh:
        """The 1-D mesh over one axis name or an ordered tuple of axes."""
        key = (axes,) if isinstance(axes, str) else tuple(axes)
        if key not in self.meshes:
            raise ValueError(f"mesh axes {axes!r} are not one of {sorted(self.meshes)}")
        return self.meshes[key]

    @property
    def stats(self) -> dict:
        """What this rank sent over all its 1-D meshes, and under "by_axes"
        what it sent over each."""
        subs = self.meshes.values()
        total = {k: sum(m.stats[k] for m in subs) for k in ("bytes_sent", "exchanges", "gathers")}
        total["largest_gather_words"] = max(m.stats["largest_gather_words"] for m in subs)
        total["by_axes"] = {",".join(k): dict(m.stats) for k, m in self.meshes.items()}
        return total

    def reset_stats(self) -> None:
        for m in self.meshes.values():
            m.reset_stats()


def make_mesh2d(shape, axes=("tp", "dp"), device=None,
                group: Optional[dist.ProcessGroup] = None) -> Mesh2D:
    """This rank's 2-D mesh over an initialised process group of
    shape[0] x shape[1] ranks (the default group unless `group` is given).
    Every process of the default group must call it, in the same order as
    any other `new_group`: it creates the sub-groups of both axes, each
    process all of them.  `device` as in `make_mesh`."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh2d: torch.distributed is not initialised "
                           "(call init_process_group first)")
    a, b = (int(v) for v in shape)
    axes = tuple(axes)
    if len(axes) != 2 or axes[0] == axes[1]:
        raise ValueError(f"make_mesh2d: need two distinct axis names, got {axes}")
    size = dist.get_world_size(group)
    if a * b != size:
        raise ValueError(f"make_mesh2d: shape {tuple(shape)} needs {a * b} ranks, the group has {size}")
    rank = dist.get_rank(group)
    backend = str(dist.get_backend(group))
    if backend not in BACKENDS:
        raise ValueError(f"make_mesh2d: backend {backend!r} is not one of {BACKENDS}")
    device = _default_device(rank) if device is None else torch.device(device)
    if backend == "nccl":
        _check_nccl_devices(group, device)  # the flattened meshes span the whole group
    glob = (lambda r: r) if group is None else (lambda r: dist.get_global_rank(group, r))
    coords = (rank // b, rank % b)
    meshes = {}
    # the sub-groups along axis 0 (one per column j), then along axis 1 (one
    # per row i), in ascending rank order: group rank = coordinate
    lines = ([(axes[0], [i * b + j for i in range(a)]) for j in range(b)]
             + [(axes[1], [i * b + j for j in range(b)]) for i in range(a)])
    for axis, ranks in lines:
        g = dist.new_group([glob(r) for r in ranks], backend=backend)
        if rank in ranks:
            meshes[(axis,)] = Mesh(group=g, rank=ranks.index(rank), size=len(ranks), axis=axis,
                                   device=device, backend=backend)
    meshes[axes] = Mesh(group=group, rank=rank, size=size, axis=",".join(axes), device=device,
                        backend=backend)
    # axes reversed: block j * a + i is group rank i * b + j
    meshes[axes[::-1]] = Mesh(group=group, rank=coords[1] * a + coords[0], size=size,
                              axis=",".join(axes[::-1]), device=device, backend=backend,
                              order=[i * b + j for j in range(b) for i in range(a)])
    return Mesh2D(shape=(a, b), axes=axes, coords=coords, device=device, meshes=meshes)


def _block(mesh: Mesh, x: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    if n % mesh.size:
        raise ValueError(f"axis {dim} of size {n} does not split over {mesh.size} ranks")
    b = n // mesh.size
    return x.narrow(dim, mesh.rank * b, b).to(mesh.device)


def shard_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous block of axis 0, on its device."""
    return _block(mesh, x, 0)


def shard_cols(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous block of axis 1, on its device."""
    return _block(mesh, x, 1)


def replicated(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The whole tensor on this rank's device."""
    return x.to(mesh.device)


def exchange(mesh: Mesh, pieces: Sequence[torch.Tensor],
             recv_shapes: Sequence[tuple]) -> List[torch.Tensor]:
    """Send `pieces[t]` to rank t and receive one tensor of `recv_shapes[s]`
    from each rank s (one `dist.all_to_all_single`, split sizes may be 0)."""
    D = mesh.size
    if len(pieces) != D or len(recv_shapes) != D:
        raise ValueError(f"exchange: need {D} pieces and {D} shapes")
    dtype = pieces[0].dtype
    order = mesh.order or range(D)  # group rank -> block: the inverse of `order`
    block_of = {g: t for t, g in enumerate(order)}
    by_group = [block_of[g] for g in range(D)]
    send_sizes = [pieces[t].numel() for t in by_group]
    recv_sizes = [int(torch.Size(recv_shapes[t]).numel()) for t in by_group]
    send = torch.cat([pieces[t].reshape(-1) for t in by_group]).to(mesh.wire)
    out = torch.empty(sum(recv_sizes), dtype=dtype, device=mesh.wire)
    dist.all_to_all_single(out, send, output_split_sizes=recv_sizes,
                           input_split_sizes=send_sizes, group=mesh.group)
    got = dict(zip(by_group, out.to(mesh.device).split(recv_sizes)))
    mesh.stats["bytes_sent"] += pieces[0].element_size() * (
        sum(send_sizes) - pieces[mesh.rank].numel())
    mesh.stats["exchanges"] += 1
    return [got[t].reshape(recv_shapes[t]) for t in range(D)]


def all_to_all(mesh: Mesh, x: torch.Tensor, split_axis: int, concat_axis: int,
               tiled: bool = False) -> torch.Tensor:
    """`lax.all_to_all` over the mesh: split `x` along `split_axis` into one
    piece per rank (tiled: D equal chunks, kept as an axis; not tiled: the
    axis must have size D and is removed), send piece t to rank t, and put
    the received pieces in rank order along `concat_axis` (tiled:
    concatenated; not tiled: stacked as a new axis there)."""
    D = mesh.size
    if tiled:
        if x.shape[split_axis] % D:
            raise ValueError(f"all_to_all: axis {split_axis} of {tuple(x.shape)} "
                             f"does not split into {D} chunks")
        pieces = list(x.chunk(D, dim=split_axis))
    else:
        if x.shape[split_axis] != D:
            raise ValueError(f"all_to_all: axis {split_axis} of {tuple(x.shape)} must be {D}")
        pieces = list(x.unbind(split_axis))
    recv = exchange(mesh, pieces, [pieces[0].shape] * D)
    return torch.cat(recv, dim=concat_axis) if tiled else torch.stack(recv, dim=concat_axis)


def all_gather(mesh: Mesh, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Every rank's `x` (same shape on each), concatenated in rank order
    along `axis`, on this rank's device."""
    wire = x.contiguous().to(mesh.wire)
    outs = [torch.empty_like(wire) for _ in range(mesh.size)]
    dist.all_gather(outs, wire, group=mesh.group)
    if mesh.order is not None:
        outs = [outs[g] for g in mesh.order]
    mesh.stats["bytes_sent"] += x.element_size() * x.numel() * (mesh.size - 1)
    mesh.stats["gathers"] += 1
    words = x.numel() * mesh.size
    mesh.stats["largest_gather_words"] = max(mesh.stats["largest_gather_words"], words)
    return torch.cat(outs, dim=axis).to(mesh.device)
