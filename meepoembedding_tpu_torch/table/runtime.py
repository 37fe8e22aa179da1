"""Table runtime: the logical `DynamicEmbeddingTable` (port of
`meepoembedding_tpu/table/runtime.py`).

It owns the static spec and the device shard and exposes lookups (probe-only
or insert-on-miss), sparse gradient updates, bulk upserts and checkpoint
restore. Eviction, removal and online growth are not ported yet: they raise
and name the item of ROADMAP.md that holds them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from meepoembedding_tpu_torch.config import TableConfig
from meepoembedding_tpu_torch.kernels import row_gather
from meepoembedding_tpu_torch.ops import dedup, optim
from meepoembedding_tpu_torch.table import hashing, table_ops
from meepoembedding_tpu_torch.table.layout import (
    ERASES,
    TableShard,
    TableSpec,
    alloc_shard,
    load_factor,
    resolve_device,
)

_LIFECYCLE = "not ported yet (ROADMAP.md, queue 1, 'Lifecycle')"


def _ids_tensor(ids64, device) -> torch.Tensor:
    if isinstance(ids64, torch.Tensor):
        return ids64.to(device=device, dtype=torch.int64).reshape(-1)
    return torch.from_numpy(np.ascontiguousarray(ids64, np.int64).reshape(-1)).to(device)


class DynamicEmbeddingTable:
    """Hash-keyed embedding table, single shard.

    >>> t = DynamicEmbeddingTable(TableConfig(dim=16, capacity=1 << 16), device="cpu")
    >>> rows = t.lookup(ids)                   # trains: insert on miss
    >>> t.apply_grads(grads)                   # sparse update of those ids
    >>> t.assign(ids, rows)                    # bulk upsert
    >>> t.lookup(ids, train=False)             # probe-only: unknown ids -> zeros
    """

    def __init__(self, cfg: TableConfig, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.spec = TableSpec.from_config(cfg, num_shards=1)
        self.shard: TableShard = alloc_shard(self.spec, self.device)
        self.step = 0
        self._last = None  # (slot [U], inverse [npad], n) of the last train lookup

    def lookup(self, ids64, train: bool = True) -> torch.Tensor:
        """[n] int64 ids (numpy or tensor) -> [n, dim] rows on the table's
        device. `train=True` inserts missed ids (fresh rows take their
        deterministic init, written into the table now, with their
        accumulator init) and remembers the slots for `apply_grads`;
        `train=False` probes only, and unknown ids give zero rows.

        The batch pads to the next power of two with the invalid id, as in
        the reference, so its unique order and capacity match exactly."""
        ids = _ids_tensor(ids64, self.device)
        n = ids.shape[0]
        npad = max(1, 1 << max(0, (n - 1).bit_length()))
        if npad != n:
            ids = torch.cat([ids, ids.new_full((npad - n,), int(hashing.EMPTY_ID))])
        hi, lo = hashing.split_ids_t(ids)
        uniq = dedup.unique_pairs(hi, lo, size=npad)
        if train:
            if self.cfg.grow_at_load is not None:
                raise NotImplementedError(f"online growth in lookup(train=True) is {_LIFECYCLE}")
            spec, shard = self.spec, self.shard
            ctx = table_ops.lookup_train(spec, shard, uniq.hi, uniq.lo, uniq.valid, self.step)
            # this API materialises fresh rows at lookup, even if apply_grads
            # never follows (the trainer folds them into its update instead)
            table_ops.scatter_add_values(shard.values, ctx.slot, ctx.rows_u, ctx.fresh)
            if shard.opt_rowwise:
                table_ops.scatter_add_bucket_plane(
                    shard.opt_rowwise[0], ctx.slot, spec.optimizer.initial_accumulator,
                    ctx.fresh)
            self._last = (ctx.slot, uniq.inverse, n)
            return row_gather(ctx.rows_u, uniq.inverse[:n]).to(spec.dtype)
        pr = table_ops.probe(self.spec, self.shard, uniq.hi, uniq.lo, uniq.valid)
        rows = table_ops.lookup_rows(self.shard, torch.where(pr.found, pr.slot, -1))
        return row_gather(rows, uniq.inverse[:n])

    def assign(self, ids64, rows) -> np.ndarray:
        """Bulk upsert of explicit rows (numpy arrays or tensors). Returns the
        bool mask of rows that landed; the rest were dropped for lack of a
        free lane within `max_probe_rounds` buckets."""
        ids = _ids_tensor(ids64, self.device)
        rows = torch.as_tensor(rows).to(self.device)
        hi, lo = hashing.split_ids_t(ids)
        ok = table_ops.insert_rows(
            self.spec, self.shard, hi, lo, rows, hashing.is_valid(hi, lo), self.step
        )
        return ok.cpu().numpy()

    def apply_grads(self, grads) -> None:
        """Sparse optimizer update of the ids of the last train lookup, with
        one [n, dim] gradient row per looked-up id (duplicates summed)."""
        if self._last is None:
            raise RuntimeError("apply_grads requires a prior lookup(train=True)")
        slot, inverse, n = self._last
        grads = torch.as_tensor(grads).to(self.device, torch.float32).reshape(-1, self.spec.dim)
        if grads.shape[0] != n:
            raise ValueError(f"grads rows {grads.shape[0]} != last lookup batch {n}")
        g = dedup.segment_sum_grads(grads, inverse[:n], num_unique=slot.shape[0])
        optim.apply_sparse_grads(self.spec, self.shard, slot, g)
        self.step += 1

    def evict(self) -> int:
        raise NotImplementedError(f"evict is {_LIFECYCLE}")

    def remove(self, ids64) -> int:
        raise NotImplementedError(f"remove is {_LIFECYCLE}")

    def __len__(self) -> int:
        return int(self.shard.cnt.sum())

    @property
    def load_factor(self) -> float:
        return load_factor(self.spec, self.shard)

    def counters(self) -> dict:
        c = self.shard.counters.cpu().numpy()
        names = ["hits", "misses", "inserts", "drops", "evictions", "spills", "promotes", "denied"]
        out = {n: int(c[i]) for i, n in enumerate(names)}
        out["erases"] = int(c[ERASES])
        return out

    def load(self, path: str) -> dict:
        """Restore from a checkpoint written with any shard count (rows are
        rehashed into this table), replacing the current contents. A table
        with `grow_at_load` sizes its capacity to the checkpoint first; a
        fixed-capacity table that cannot hold it raises."""
        from meepoembedding_tpu_torch import checkpoint

        total = sum(checkpoint.read_manifest(path).get("counts", [0]))
        while (
            self.cfg.grow_at_load is not None
            and total > self.cfg.grow_at_load * self.spec.capacity
        ):
            self.cfg = dataclasses.replace(self.cfg, capacity=self.cfg.capacity * 2)
            self.spec = TableSpec.from_config(self.cfg, num_shards=1)
        # drop the old planes before the new ones are allocated: at 2^27 slots
        # a shard holds ~18.5 GiB
        self.shard = None
        shards, manifest = checkpoint.restore_shards(self.spec, path, 1, device=self.device)
        self.shard = shards[0]
        self.step = manifest["step"]
        return manifest
