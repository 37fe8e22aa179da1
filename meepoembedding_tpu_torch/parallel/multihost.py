"""Host-side collectives of the row-sharded layer (port of
`meepoembedding_tpu/parallel/multihost.py`).

  shard_batch         a global batch array -> this rank's rows on its device
  all_processes_sum   sum of a host scalar over the ranks (metrics)
  barrier             a sync point of the checkpoint protocol

Both collectives reduce a float64 on the mesh's device (NCCL takes no host
tensor), so they wait for the device. The reference's `all_processes_max`
agreed on a number of promotion rounds, which one program across devices
needed; the port's promotion inserts are local to a rank
(`trainer.drain_promotions`), so it has no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from meepoembedding_tpu_torch.parallel.mesh import Mesh


def shard_batch(arr, mesh: Mesh) -> torch.Tensor:
    """Rows [r * B / S, (r + 1) * B / S) of a global batch array, on the
    mesh's device: this rank's slice, for callers that hold the whole
    batch. The trainers and services take each rank's own rows."""
    a = np.asarray(arr)
    b = a.shape[0]
    if b % mesh.size:
        raise ValueError(f"a batch of {b} rows does not split over {mesh.size} ranks")
    per = b // mesh.size
    return torch.from_numpy(np.ascontiguousarray(a[mesh.rank * per:(mesh.rank + 1) * per])
                            ).to(mesh.device)


def all_processes_sum(x: float, mesh: Mesh) -> float:
    """A host scalar summed over the ranks, as a float64."""
    t = torch.tensor([float(x)], dtype=torch.float64, device=mesh.device)
    if mesh.size > 1:
        dist.all_reduce(t, group=mesh.group)
    return float(t.item())


def barrier(name: str, mesh: Mesh) -> None:
    """Every rank waits here for the others; `name` says which point of a
    protocol this is (it appears in a timeout's traceback). An all-reduce
    on the mesh's device, which every backend runs."""
    if mesh.size > 1:
        t = torch.zeros((1,), dtype=torch.float64, device=mesh.device)
        dist.all_reduce(t, group=mesh.group)
        t.item()
