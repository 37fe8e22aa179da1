"""Process groups for the row-sharded layer (port of
`meepoembedding_tpu/parallel/mesh.py`).

The reference's 1-D mesh is S devices of one program over the axis "d":
the batch is split over it and each device owns one table shard. Here a
rank is a process: it holds its shard and its slice of the batch on one
device, and the collectives run over a `torch.distributed` process group
(NCCL between cards, gloo between CPU processes). `Mesh` is that group
with its size S, this process's rank and its device.

  >>> mesh = make_mesh(device="cpu")          # a world of one, no setup
  >>> init_distributed("gloo", "file:///tmp/store", rank, 4, device="cpu")
  >>> mesh = make_mesh(device="cpu")          # a world of 4

`make_mesh2d(S, C)` lays a world of S * C ranks out as the grid of a
column-sharded table (`parallel/colsharded.py`): each rank gets the mesh
of its column (S ranks, the exchange) and of its row shard (C ranks, the
lane blocks).

A group made with backend "cpu:gloo,cuda:nccl" (the default for a CUDA
device) carries both CPU and CUDA tensors, so one process can run the same
code on either device. There is no fallback: if NCCL cannot start, the
collective that needs it raises.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from meepoembedding_tpu_torch.table.layout import resolve_device

_TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A process group seen from one of its ranks."""

    group: Optional[dist.ProcessGroup]  # None: the default group
    size: int  # S, the number of shards
    rank: int  # this process's shard
    device: torch.device  # where this rank's shard, batch and collectives live


def init_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                     rank: int = 0, world_size: int = 1, device="cuda") -> None:
    """Join the default process group (the reference's
    `jax.distributed.initialize`); a no-op when it exists. `init_method` is
    where the ranks meet ("tcp://host:port" or "file:///path"); without
    one, a single process (`world_size` 1) starts a world of one on a store
    at a free local port. A CUDA device becomes this process's current
    device (`cuda` alone picks card `rank % device_count`)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else rank % torch.cuda.device_count())
    if dist.is_initialized():
        return
    backend = backend or ("cpu:gloo,cuda:nccl" if dev.type == "cuda" else "gloo")
    if init_method is None:
        if world_size != 1:
            raise ValueError(f"a world of {world_size} needs an init_method where its ranks meet")
        store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True, timeout=_TIMEOUT)
        dist.init_process_group(backend, store=store, rank=0, world_size=1, timeout=_TIMEOUT)
        return
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=_TIMEOUT)


def make_mesh(group: Optional[dist.ProcessGroup] = None, device="cuda") -> Mesh:
    """The mesh of `group` (default: the world) on `device`. With no group
    yet, this process starts a world of one (`init_distributed`). A CUDA
    device without an index is the current card."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        init_distributed(device=dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(group=group, size=dist.get_world_size(group), rank=dist.get_rank(group),
                device=dev)


class Mesh2D(NamedTuple):
    """The (row x column) grid of a column-sharded table
    (`parallel/colsharded.py`), seen from one rank: world rank r = s * C +
    c holds lanes [c * dim / C, (c + 1) * dim / C) of row shard s."""

    world: Mesh  # all S * C ranks (the checkpoint protocol's barriers)
    row: Mesh  # column c's S ranks {c, C + c, ...}: the id exchange; rank s
    col: Mesh  # row shard s's C ranks {s * C, ..., s * C + C - 1}; rank c

    @property
    def S(self) -> int:
        return self.row.size

    @property
    def C(self) -> int:
        return self.col.size


def make_mesh2d(num_row: int, num_col: int, device="cuda") -> Mesh2D:
    """The 2-D grid over a world of num_row * num_col ranks, rank r = s * C
    + c as the reference's `devs.reshape(S, C)`. Every rank creates every
    subgroup, in the same order (`dist.new_group` is a collective of the
    world), with the world's backend; a subgroup that is the whole world is
    the default group. Without a world yet, this process starts one of one
    (`init_distributed`)."""
    world = make_mesh(device=device)
    S, C = num_row, num_col
    if world.size != S * C:
        raise ValueError(f"a {S} x {C} grid needs a world of {S * C} ranks, "
                         f"not {world.size}")

    def group(ranks):
        return None if len(ranks) == world.size else dist.new_group(ranks, timeout=_TIMEOUT)

    s, c = divmod(world.rank, C)
    rows = [group([si * C + ci for si in range(S)]) for ci in range(C)]
    cols = [group([si * C + ci for ci in range(C)]) for si in range(S)]
    return Mesh2D(world=world,
                  row=Mesh(group=rows[c], size=S, rank=s, device=world.device),
                  col=Mesh(group=cols[s], size=C, rank=c, device=world.device))


def destroy() -> None:
    """Leave the default process group (the end of a run)."""
    if dist.is_initialized():
        dist.destroy_process_group()
