"""Column-sharded (row x dim) table (port of
`meepoembedding_tpu/parallel/colsharded.py`).

A grid of S x C ranks (`mesh.make_mesh2d`): rank r = s * C + c holds
lanes [c * dim / C, (c + 1) * dim / C) of every row of row shard s. Along a
column the ranks are `ShardedTrainer`'s S ranks: the batch is split over
them and ids route to their owners over the exchange. Across the C ranks of
a row shard the batch is the same, and so are the key and metadata planes:
probe, insert planning, admission, growth, erase and eviction are pure
functions of the key planes and the ids, so every column evolves them bit
for bit alike with no collective. Only the value-like planes differ:

  - fresh rows draw their own lanes of the full-dim init
    (`TableSpec.init_lane_offset`, set by `col_local_spec`), so the C blocks
    concatenated equal a full-dim table's init;
  - the exchange carries dim / C lanes a row;
  - the tower all-gathers the [U, dim / C] blocks over the column into [U,
    dim] outside autograd, runs on full rows (the same on every column)
    and each column keeps its own block of the rows' gradients;
  - the rowwise accumulator is a full-row statistic: the raw per-row sum
    of squares is all-reduced over the column and divided by the full dim
    (`optim.apply_sparse_grads_ctx`'s `g2_mean`), so it is the same on
    every column; full-dim optimizer state is per lane.

The tower's gradients are the same on every column, so they are summed
over the row's S ranks only, as are the loss and the route drops.

The cold tier cannot follow the reference, which merges the C blocks of an
evicted row in one process. Here each column is a process, so the column-0
rank of each row shard owns its spill backend and `PromotionEngine`: on
eviction the other columns send it their blocks of the evicted rows
(`all_gather` over the column) and it spills canonical full-dim rows; on
promotion it broadcasts the drained keys and full rows, and every column
inserts its own block. The cold tier holds what the reference's does.

Every rank must call the same methods in the same order, as
`ShardedTrainer`'s do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from meepoembedding_tpu_torch.config import ModelConfig, RunConfig, TableConfig
from meepoembedding_tpu_torch.parallel import multihost
from meepoembedding_tpu_torch.parallel.mesh import Mesh2D
from meepoembedding_tpu_torch.parallel.trainer import (
    PROMOTE_CHUNK,
    PromoteStats,
    ShardedTrainer,
)
from meepoembedding_tpu_torch.table import hashing, table_ops
from meepoembedding_tpu_torch.table.layout import PROMOTES, TableSpec
from meepoembedding_tpu_torch.weights import to_jax_adam_state, to_jax_params


def col_local_spec(spec: TableSpec, num_col: int, col: int = 0) -> TableSpec:
    """Column `col`'s block of a table: dim / C lanes of every row, fresh
    rows drawing lanes [col * dim / C, (col + 1) * dim / C) of the init."""
    if spec.dim % num_col:
        raise ValueError(f"dim {spec.dim} does not split into {num_col} column blocks")
    d = spec.dim // num_col
    return dataclasses.replace(spec, dim=d, init_lane_offset=spec.init_lane_offset + col * d)


class ColShardedTrainer(ShardedTrainer):
    """The 2-D trainer for very wide tables: `ShardedTrainer`'s step API on
    the grid `mesh2d`, each rank holding one column block of its row
    shard. `spec` is the full table's geometry, `spec_local` this rank's
    block. `spill` is the row shard's cold tier, given on its column-0 rank
    only (None on the others, which learn of it at construction). Like the
    reference's, the step takes the dense exchange and trains the tower at
    the constant `dense_learning_rate`."""

    def __init__(self, run_cfg: RunConfig, table_cfg: TableConfig, model_cfg: ModelConfig,
                 mesh2d: Mesh2D, spill=None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        self.mesh2d, self.col, self.C = mesh2d, mesh2d.col, mesh2d.C
        if spill is not None and self.col.rank != 0:
            raise ValueError("a row shard's cold tier lives on its column-0 rank; pass "
                             "spill=None on the others")
        super().__init__(run_cfg, table_cfg, model_cfg, mesh=mesh2d.row, spill=spill,
                         device=device, generator=generator)
        self.a2a_ragged = False
        flag = torch.tensor([spill is not None], dtype=torch.int32, device=self.device)
        self._col_broadcast(flag)
        self._spilling = bool(flag.item())

    # --- the column layout -----------------------------------------------------
    def _local(self, spec: TableSpec) -> TableSpec:
        return col_local_spec(spec, self.C, self.col.rank)

    def _lane_slice(self, spec_local: TableSpec):
        return (spec_local.init_lane_offset, spec_local.dim)

    def _full_rows(self, emb_u: torch.Tensor) -> torch.Tensor:
        """[U, dim / C] blocks all-gathered over the column into [U, dim]."""
        if self.C == 1:
            return emb_u
        parts = [torch.empty_like(emb_u) for _ in range(self.C)]
        dist.all_gather(parts, emb_u.contiguous(), group=self.col.group)
        return torch.cat(parts, dim=1)

    def _own_block(self, g_rows: torch.Tensor) -> torch.Tensor:
        o = self.spec_local.init_lane_offset
        return g_rows[:, o:o + self.spec_local.dim].contiguous()

    def _g2_mean(self, s2: torch.Tensor) -> torch.Tensor:
        if self.C > 1:
            dist.all_reduce(s2, group=self.col.group)
        return s2 / self.spec.dim

    def _dense_lr(self) -> float:
        return self.run_cfg.dense_learning_rate

    def _col_broadcast(self, t: torch.Tensor) -> None:
        """`t` from the row shard's column-0 rank to its other columns."""
        if self.C > 1:
            dist.broadcast(t, src=self.mesh2d.world.rank - self.col.rank, group=self.col.group)

    # --- the cold tier on column 0 ---------------------------------------------
    def _spill(self, export) -> None:
        """The evicted rows' blocks to column 0, which spills full-dim rows.
        Every column evicted the same rows in the same order."""
        if not self._spilling:
            return
        from meepoembedding_tpu_torch.tiering import SpillCodec, spill_export

        n = export.count
        planes = [export.rows[:n].float(), *(f[:n].float() for f in export.fulldim)]
        full = []
        for p in planes:
            if self.C == 1:
                full.append(p)
                continue
            parts = [torch.empty_like(p) for _ in range(self.C)]
            dist.all_gather(parts, p.contiguous(), group=self.col.group)
            full.append(torch.cat(parts, dim=1))
        if self.spill is not None:
            spill_export(SpillCodec(self.spec), self.spill, export._replace(
                rows=full[0], fulldim=tuple(full[1:])))
        self.spilled_rows += n

    def _apply_promotions(self) -> PromoteStats:
        """Column 0 drains its promoter and broadcasts the keys and full rows
        (in the cold tier's codec); every column inserts its own block, in
        lockstep, so the same rows land everywhere. Slot-race losers go back
        to the cold tier from column 0."""
        if not self._spilling:
            return PromoteStats()
        from meepoembedding_tpu_torch.tiering import SpillCodec, respill_failed

        codec = SpillCodec(self.spec)
        dev = self.device
        drained = self._promoter.drain() if self._promoter is not None else None
        n = torch.tensor([0 if drained is None else len(drained[0])], device=dev)
        self._col_broadcast(n)
        n = int(n.item())
        if not n:
            # the row mesh's sum is a collective that another row shard, with
            # rows staged, waits in; the bound must agree on every rank
            self._live_upper += int(multihost.all_processes_sum(0, self.mesh))
            return PromoteStats()
        keys = torch.empty((n,), dtype=torch.int64, device=dev)
        payload = torch.empty((n, codec.width), dtype=torch.float32, device=dev)
        if drained is not None:
            st_ = drained[1]
            keys.copy_(torch.from_numpy(drained[0]))
            payload.copy_(torch.from_numpy(codec.pack(st_["values"], st_["freq"],
                                                      st_.get("accum"), st_["fulldim"])))
        self._col_broadcast(keys)
        self._col_broadcast(payload)
        state = codec.unpack(payload.cpu().numpy())
        spec = self.spec_local
        o, d = spec.init_lane_offset, spec.dim
        hi, lo = hashing.split_ids_t(keys)

        def t(a, sl):
            return torch.from_numpy(np.ascontiguousarray(a[sl])).to(dev)

        oks = []
        for c0 in range(0, n, PROMOTE_CHUNK):
            sl = slice(c0, c0 + PROMOTE_CHUNK)
            m = hi[sl].shape[0]
            ok = table_ops.insert_rows(
                spec, self.shard, hi[sl], lo[sl], t(state["values"][:, o:o + d], sl),
                torch.ones((m,), dtype=torch.bool, device=dev), self.step,
                freq=t(state["freq"], sl),
                accum=t(state["accum"], sl) if "accum" in state else None,
                fulldim=[t(f[:, o:o + d], sl) for f in state["fulldim"]] or None)
            self.shard.counters[PROMOTES] += ok.sum().to(torch.int32)
            oks.append(ok)
        ok = torch.cat(oks)
        respilled = int((~ok).sum())
        if drained is not None:
            respill_failed(self._promoter, drained[0], drained[1], ok)
        self.promote_respills += respilled
        self._live_upper += int(multihost.all_processes_sum(n - respilled, self.mesh))
        return PromoteStats(staged=n, inserted=n - respilled, respilled=respilled)

    # --- checkpoints --------------------------------------------------------------
    def save_checkpoint(self, path: str, extras: Optional[dict] = None) -> dict:
        """Each rank writes its lane block (`checkpoint.save_sharded2d`);
        world rank 0 the tower and the manifest. The checkpoint restores
        onto any layout: one device, S row shards or another grid."""
        from meepoembedding_tpu_torch import checkpoint

        self.flush()
        world = self.mesh2d.world
        coord = world.rank == 0
        dense = ({"params": to_jax_params(self.model),
                  "opt_state": to_jax_adam_state(self.opt_state, self.model)}
                 if coord else None)
        return checkpoint.save_sharded2d(
            path, self.spec_local, self.spec.dim, {(self.mesh.rank, self.col.rank): self.shard},
            self.S, self.C, self.step, extras=extras, dense=dense, is_coordinator=coord,
            barrier=lambda name="": multihost.barrier(name, world))
