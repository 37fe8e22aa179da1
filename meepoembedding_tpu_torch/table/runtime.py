"""Table runtime: the logical `DynamicEmbeddingTable` (port of
`meepoembedding_tpu/table/runtime.py`).

It owns the static spec and the device shard and exposes lookups (probe-only
or insert-on-miss), sparse gradient updates, bulk upserts, eviction with an
optional spill tier and promotion back from it, key removal, online growth
by rehash into a table twice the size, and checkpoint save and restore.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from meepoembedding_tpu_torch.config import LANES, TableConfig
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
from meepoembedding_tpu_torch.tracing import span

REGROW_BATCH = 1 << 14  # rows a regrow insert batch: slot placement depends on it



def _ids_tensor(ids64, device) -> torch.Tensor:
    if isinstance(ids64, torch.Tensor):
        return ids64.to(device=device, dtype=torch.int64).reshape(-1)
    return torch.from_numpy(np.ascontiguousarray(ids64, np.int64).reshape(-1)).to(device)


def regrow_shard(old_spec: TableSpec, new_spec: TableSpec, old_shard: TableShard,
                 step: int) -> TableShard:
    """Rehash one shard's live rows (values, freq, last and optimizer state)
    into a fresh shard of `new_spec`'s geometry: the rows go to the host
    (`checkpoint.export_shard_arrays`, ascending slot order) and are
    re-inserted in the reference's batches of `REGROW_BATCH` rows, the last
    one padded with the invalid id, so every row lands in the slot the
    reference gives it. The counters carry over (the re-inserts add to
    `inserts`, as in the reference). Peak memory is the old and the new
    shard plus the host copy."""
    from meepoembedding_tpu_torch import checkpoint

    dev = old_shard.key_hi.device
    new_shard = alloc_shard(new_spec, dev)
    new_shard.counters.copy_(old_shard.counters)
    arrs = checkpoint.export_shard_arrays(old_spec, old_shard)
    n = arrs["ids"].shape[0]
    n_full = new_spec.optimizer.num_fulldim_slots()
    b = REGROW_BATCH
    valid_all = torch.arange(b, device=dev)
    hi_np, lo_np = hashing.split_ids(arrs["ids"])
    for o in range(0, n, b):
        cnt = min(n, o + b) - o

        def pick(a, fill=0):
            x = torch.from_numpy(np.ascontiguousarray(a[o:o + cnt])).to(dev)
            if cnt < b:
                x = torch.cat([x, x.new_full((b - cnt,) + x.shape[1:], fill)])
            return x

        table_ops.insert_rows(
            new_spec, new_shard, pick(hi_np, hashing.EMPTY_HI), pick(lo_np, hashing.EMPTY_LO),
            pick(arrs["values"]), valid_all < cnt, step, freq=pick(arrs["freq"]),
            accum=pick(arrs["accum"]) if "accum" in arrs else None,
            fulldim=[pick(arrs[f"full{j}"]) for j in range(n_full)] or None,
            last=pick(arrs["last"]),
        )
    return new_shard


class DynamicEmbeddingTable:
    """Hash-keyed growable, evictable embedding table, single shard.

    >>> t = DynamicEmbeddingTable(TableConfig(dim=16, capacity=1 << 16), device="cpu")
    >>> rows = t.lookup(ids)                   # trains: insert on miss
    >>> t.apply_grads(grads)                   # sparse update of those ids
    >>> t.assign(ids, rows)                    # bulk upsert
    >>> t.lookup(ids, train=False)             # probe-only: unknown ids -> zeros
    >>> t.evict(); t.remove(ids)               # lifecycle

    `spill` is an optional `KVBackend` cold tier: evicted rows go there, and
    train lookups that miss promote them back. `shard` starts the table on
    an existing shard of the same geometry, which it then updates in place.
    """

    def __init__(self, cfg: TableConfig, device="cuda", spill=None,
                 shard: Optional[TableShard] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.spec = TableSpec.from_config(cfg, num_shards=1)
        if shard is None:
            shard = alloc_shard(self.spec, self.device)
        elif tuple(shard.values.shape) != (self.spec.capacity, self.spec.dim):
            raise ValueError(f"shard values {tuple(shard.values.shape)} do not match the "
                             f"table's [{self.spec.capacity}, {self.spec.dim}]")
        self.shard: TableShard = shard
        self.step = 0
        self.spill = spill
        self.spilled_rows = 0
        self._evict_cursor = 0
        self._last = None  # (slot [U], inverse [npad], n) of the last train lookup
        self._codec = self._promoter = None
        if spill is not None:
            from meepoembedding_tpu_torch.tiering import PromotionEngine, SpillCodec

            self._codec = SpillCodec(self.spec)
            if spill.width != self._codec.width:
                raise ValueError(f"spill backend width {spill.width} != codec width "
                                 f"{self._codec.width} (dim + freq + optimizer slots)")
            self._promoter = PromotionEngine(self._codec, spill)

    # --- online growth ------------------------------------------------------
    def _maybe_grow(self, incoming: int) -> None:
        """Double the capacity until the incoming batch fits under the growth
        load threshold. Pessimistic: every incoming id counts as an insert,
        so a burst of new ids is never dropped for capacity."""
        if self.cfg.grow_at_load is None:
            return
        while len(self) + incoming > self.cfg.grow_at_load * self.spec.capacity:
            self._grow()

    def _grow(self) -> None:
        """Rehash every live row into a table of twice the capacity
        (`regrow_shard`)."""
        old_spec, old_shard = self.spec, self.shard
        self.cfg = dataclasses.replace(self.cfg, capacity=old_spec.capacity * 2)
        self.spec = TableSpec.from_config(self.cfg, num_shards=1)
        self.shard = regrow_shard(old_spec, self.spec, old_shard, self.step)

    # --- host-facing API ----------------------------------------------------
    def lookup(self, ids64, train: bool = True) -> torch.Tensor:
        """[n] int64 ids (numpy or tensor) -> [n, dim] rows on the table's
        device. `train=True` first grows the table if the batch could push
        it past `grow_at_load` and inserts the promotions staged from the
        spill tier, then inserts missed ids (fresh rows take their
        deterministic init, written into the table now, with their
        accumulator init), remembers the slots for `apply_grads` and feeds
        the misses to the promoter; `train=False` probes only, and unknown
        ids give zero rows.

        The batch pads to the next power of two with the invalid id, as in
        the reference, so its unique order and capacity match exactly."""
        ids = _ids_tensor(ids64, self.device)
        n = ids.shape[0]
        npad = max(1, 1 << max(0, (n - 1).bit_length()))
        if npad != n:
            ids = torch.cat([ids, ids.new_full((npad - n,), int(hashing.EMPTY_ID))])
        hi, lo = hashing.split_ids_t(ids)
        if not train:
            uniq = dedup.unique_pairs(hi, lo, size=npad)
            pr = table_ops.probe(self.spec, self.shard, uniq.hi, uniq.lo, uniq.valid)
            with span("meepo.table.gather"):
                rows = table_ops.lookup_rows(self.shard, torch.where(pr.found, pr.slot, -1))
                return row_gather(rows, uniq.inverse[:n])
        self._maybe_grow(n)
        self._apply_promotions()
        spec, shard = self.spec, self.shard
        uniq = dedup.unique_pairs(hi, lo, size=npad)
        ctx = table_ops.lookup_train(spec, shard, uniq.hi, uniq.lo, uniq.valid, self.step)
        # this API materialises fresh rows at lookup, even if apply_grads
        # never follows (the trainer folds them into its update instead)
        table_ops.scatter_add_values(shard.values, ctx.slot, ctx.rows_u, ctx.fresh)
        if shard.opt_rowwise:
            table_ops.scatter_add_bucket_plane(
                shard.opt_rowwise[0], ctx.slot, spec.optimizer.initial_accumulator,
                ctx.fresh)
        self._last = (ctx.slot, uniq.inverse, n)
        if self._promoter is not None:
            self._promoter.feed(uniq.hi, uniq.lo, uniq.valid & ~ctx.found)
        return row_gather(ctx.rows_u, uniq.inverse[:n]).to(spec.dtype)

    def _apply_promotions(self) -> None:
        """Insert the staged cold->hot promotions into the device table with
        their spilled state; rows that lose the slot race (a full table)
        go back to the cold tier with their payload (`respill_failed`)."""
        if self._promoter is None:
            return
        out = self._promoter.drain()
        if out is None:
            return
        from meepoembedding_tpu_torch.tiering import respill_failed

        keys, state = out
        hi, lo = hashing.split_ids(keys)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        ok = table_ops.insert_rows(
            self.spec, self.shard, dev(hi), dev(lo), dev(state["values"]),
            torch.ones((len(keys),), dtype=torch.bool, device=self.device), self.step,
            freq=dev(state["freq"]),
            accum=dev(state["accum"]) if "accum" in state else None,
            fulldim=[dev(f) for f in state["fulldim"]] or None,
        )
        respill_failed(self._promoter, keys, state, ok)

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

    def remove(self, ids64) -> int:
        """Free the listed ids' slots (deletion: removed rows do not go to
        the spill tier; `evict` demotes). Absent ids are a no-op. Returns how
        many were removed."""
        uniq = torch.unique(_ids_tensor(ids64, self.device))
        hi, lo = hashing.split_ids_t(uniq)
        found = table_ops.erase_keys(self.spec, self.shard, hi, lo, hashing.is_valid(hi, lo))
        return int(found.sum())

    def evict(self) -> int:
        """One eviction sweep over the next window of buckets; the evicted
        rows (values and optimizer state) go to the spill tier, if any.
        Returns the number of rows evicted."""
        off = self._evict_cursor
        self._evict_cursor = table_ops.next_evict_cursor(self.spec, off)
        export = table_ops.evict_pass(self.spec, self.shard, self.step, off)
        n = export.count
        if n and self.spill is not None:
            from meepoembedding_tpu_torch.tiering import spill_export

            spill_export(self._codec, self.spill, export)
            self.spilled_rows += n
        return n

    # --- introspection ------------------------------------------------------
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
        if self._promoter is not None:
            out["promotes"] = self._promoter.promoted
            out["promote_respills"] = self._promoter.respilled
            out["spilled_resident"] = len(self.spill)
        # spilling runs on the host, so the device counter never sees it
        out["spills"] = max(out["spills"], self.spilled_rows)
        return out

    # --- checkpoint ---------------------------------------------------------
    def save(self, path: str, extras: Optional[dict] = None) -> dict:
        """Write this table as a one-shard checkpoint directory."""
        from meepoembedding_tpu_torch import checkpoint

        return checkpoint.save(path, self.spec, [self.shard], self.step, extras=extras)

    def load(self, path: str) -> dict:
        """Restore from a checkpoint written with any shard count (rows are
        rehashed into this table), replacing the current contents. A table
        with `grow_at_load` sizes its capacity to the checkpoint first; a
        fixed-capacity table that cannot hold it raises."""
        from meepoembedding_tpu_torch import checkpoint

        m = checkpoint.read_manifest(path)
        total = sum(m.get("counts", [0]))
        cfg = self.cfg
        spec = TableSpec.from_config(cfg, num_shards=1)
        while cfg.grow_at_load is not None and total > cfg.grow_at_load * spec.capacity:
            cfg = dataclasses.replace(cfg, capacity=cfg.capacity * 2)
            spec = TableSpec.from_config(cfg, num_shards=1)
        # a checkpoint that does not fit raises here, with the table intact
        checkpoint.check_manifest(spec, m)
        # drop the old planes before the new ones are allocated: at 2^27 slots
        # a shard holds ~18.5 GiB
        self.shard = None
        shards, manifest = checkpoint.restore_shards(spec, path, 1, device=self.device)
        self.cfg, self.spec, self.shard = cfg, spec, shards[0]
        self.step = manifest["step"]
        return manifest

    def export_items(self, chunk_buckets: int = 4096) -> Iterator[tuple]:
        """Stream (ids64, rows, freq, accum) of the live rows to the host as
        numpy chunks of `chunk_buckets` buckets, in slot order. The rows keep
        the values plane's dtype, as in the reference, so they come as a CPU
        tensor (numpy has no bfloat16); the rest are numpy arrays."""
        from meepoembedding_tpu_torch import checkpoint

        shard = self.shard
        for b0 in range(0, self.spec.num_buckets, chunk_buckets):
            b1 = b0 + chunk_buckets
            live = hashing.is_valid(shard.key_hi[b0:b1], shard.key_lo[b0:b1])
            (lanes,) = live.view(-1).nonzero(as_tuple=True)
            if lanes.shape[0] == 0:
                continue
            part = checkpoint._fetch_chunk(shard, (lanes + b0 * LANES).to(torch.int32))
            freq = part["freq"].numpy()
            acc = part["accum"].numpy() if "accum" in part else np.zeros_like(freq, np.float32)
            yield part["ids"].numpy(), part["values"], freq, acc
