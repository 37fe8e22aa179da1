"""Row-sharded trainer (port of `meepoembedding_tpu/parallel/trainer.py`).

One process a rank. Each rank holds one table shard and a replica of the
dense tower, and trains on its own rows of the global batch (`batch_size`
/ S of them). A step, in the reference's order:

  1. dedup the rank's ids (owner-major when the ragged exchange runs, so
     the dedup's sort is also the send buffer's);
  2. `sharded_table.exchange_lookup`: the ids go to their owners, which
     find or insert them, and the rows come back;
  3. the tower on the rank's rows, its loss divided by S, so that the
     gradients sum to the global batch's mean;
  4. `exchange_apply_grads`: the rows' gradients go back to the owners and
     update their shards in place;
  5. one all-reduce of the dense gradients, flattened into one buffer with
     the loss and the route drops;
  6. clip, the LR schedule and the reference's dense Adam, the same on
     every rank.

`pipeline_depth = d` defers reading a step's scalars until d steps later:
`train_step` returns the loss of step `step - d` (None for the first d
steps), and `flush()` retires the rest. Route drops (ids past the
exchange's capacity, which trained from zero rows) double `a2a_factor`,
up to S; a resize changes the capacities of later steps, and steps that
were in flight when it fired do not double it again.

Every rank must call the same methods in the same order, with batches of
the same shape: each step, eval, growth, removal, maintenance, save and
restore runs collectives.

Multi-hot [B, S, L] bags go to the exchange padded, for every model: the
single-device `train.Trainer`'s ragged paths (pooled, and positional for
din and bst, `ops/pooling.py`) are not taken here, so padding slots are
deduplicated and routed with the ids (ROADMAP queue 5, item 4(a)).
"""

from __future__ import annotations

import dataclasses
import logging
from collections import deque
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from meepoembedding_tpu_torch.config import LANES, ModelConfig, RunConfig, TableConfig
from meepoembedding_tpu_torch.metrics import StreamingAUC
from meepoembedding_tpu_torch.models import build_model
from meepoembedding_tpu_torch.models.common import batch_item_key, model_inputs, model_loss
from meepoembedding_tpu_torch.ops import dedup, optim
from meepoembedding_tpu_torch.ops.itemfreq import ItemFrequencyEstimator, item_keys_np
from meepoembedding_tpu_torch.parallel import multihost
from meepoembedding_tpu_torch.parallel import ragged as rg
from meepoembedding_tpu_torch.parallel import sharded_table as st
from meepoembedding_tpu_torch.parallel.mesh import Mesh, make_mesh
from meepoembedding_tpu_torch.table import hashing, table_ops
from meepoembedding_tpu_torch.table.layout import (
    ERASES,
    PROMOTES,
    TableShard,
    TableSpec,
    alloc_shard,
)
from meepoembedding_tpu_torch.train import COUNTER_NAMES, _host_ids, _tensor
from meepoembedding_tpu_torch.weights import (
    from_jax_adam_state,
    from_jax_params,
    param_leaves,
    to_jax_adam_state,
    to_jax_params,
)

SHARDED_COUNTER_NAMES = COUNTER_NAMES + ("route_drops",)
PROMOTE_CHUNK = 1024  # rows a promotion insert


def sum_over_ranks(tensors, mesh: Mesh) -> list:
    """The tensors summed over the ranks in ONE all-reduce: flattened into
    an f32 buffer and split back, each in its own shape and type. Integers
    are exact below 2^24."""
    if mesh.size == 1:
        return [t.detach() for t in tensors]
    flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    out, o = [], 0
    for t in tensors:
        out.append(flat[o:o + t.numel()].reshape(t.shape).to(t.dtype))
        o += t.numel()
    return out


def sum_ints(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """An integer tensor summed over the ranks, in int64."""
    t = t.to(torch.int64)
    if mesh.size > 1:
        dist.all_reduce(t, group=mesh.group)
    return t


class PromoteStats(NamedTuple):
    """Every staged row is inserted into the shard or re-spilled to the
    cold tier: staged == inserted + respilled."""

    staged: int = 0
    inserted: int = 0
    respilled: int = 0


def drain_promotions(spec: TableSpec, shard: TableShard, promoter, step: int,
                     chunk: int = PROMOTE_CHUNK) -> PromoteStats:
    """Insert a `PromotionEngine`'s staged rows into this rank's shard, in
    place, `chunk` rows an insert. The staged keys missed on this very
    shard, so owner routing (a pure hash) makes them its own, and the
    inserts are local: ranks need not agree on a number of rounds, as the
    reference's one program across devices had to. PROMOTES counts the
    rows that landed; those that lose the slot race (a full table) go back
    to the cold tier with their payload (`respill_failed`)."""
    from meepoembedding_tpu_torch.tiering import respill_failed

    out = promoter.drain()
    if out is None:
        return PromoteStats()
    keys, state = out
    hi, lo = hashing.split_ids(keys)
    dev = shard.key_hi.device

    def t(a, sl):
        return torch.from_numpy(np.ascontiguousarray(a[sl])).to(dev)

    oks = []
    for o in range(0, len(keys), chunk):
        sl = slice(o, o + chunk)
        n = len(keys[sl])
        ok = table_ops.insert_rows(
            spec, shard, t(hi, sl), t(lo, sl), t(state["values"], sl),
            torch.ones((n,), dtype=torch.bool, device=dev), step, freq=t(state["freq"], sl),
            accum=t(state["accum"], sl) if "accum" in state else None,
            fulldim=[t(f, sl) for f in state["fulldim"]] or None)
        shard.counters[PROMOTES] += ok.sum().to(torch.int32)
        oks.append(ok)
    respilled = respill_failed(promoter, keys, state, torch.cat(oks))
    return PromoteStats(staged=len(keys), inserted=len(keys) - respilled, respilled=respilled)


class ShardedTrainer:
    """The single-device `Trainer` over S ranks (BASELINE config 3). The
    tower starts He-initialised from `generator` (default: a CPU generator
    seeded with `run_cfg.seed`, so every rank starts from the same tower).
    `mesh` defaults to the world on `device`; `spill` is an optional
    `KVBackend` for this rank's evicted rows, from which its misses are
    promoted back at maintenance."""

    def __init__(self, run_cfg: RunConfig, table_cfg: TableConfig, model_cfg: ModelConfig,
                 mesh: Optional[Mesh] = None, spill=None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        if model_cfg.embedding_dim != table_cfg.dim:
            raise ValueError(f"model embedding_dim {model_cfg.embedding_dim} != "
                             f"table dim {table_cfg.dim}")
        self.mesh = mesh or make_mesh(device=device)
        self.S, self.device = self.mesh.size, self.mesh.device
        if run_cfg.batch_size % self.S:
            raise ValueError(f"global batch {run_cfg.batch_size} does not split over "
                             f"{self.S} ranks")
        self.run_cfg, self.table_cfg, self.model_cfg = run_cfg, table_cfg, model_cfg
        self.spec = TableSpec.from_config(table_cfg, num_shards=self.S)
        self.shard = alloc_shard(self.spec_local, self.device)
        gen = generator if generator is not None else torch.Generator().manual_seed(run_cfg.seed)
        self.model = build_model(model_cfg, generator=gen).to(self.device)
        self.params = [p for p, _ in param_leaves(self.model)]
        self.opt_state = optim.dense_adam_init(self.params)
        self.step = 0
        self.spill = spill
        self.spilled_rows = 0
        self.promote_respills = 0
        self._evict_cursor = 0
        self._promoter = None
        if spill is not None:
            from meepoembedding_tpu_torch.tiering import PromotionEngine, SpillCodec

            codec = SpillCodec(self.spec)
            if spill.width != codec.width:
                raise ValueError(f"spill backend width {spill.width} != codec width "
                                 f"{codec.width}")
            self._promoter = PromotionEngine(codec, spill)
        self._freq_est = None
        if model_cfg.logq_correction:
            if not hasattr(self.model, "loss_and_logits"):
                raise ValueError("model.logq_correction needs a retrieval model (two_tower), "
                                 f"not {model_cfg.kind!r}")
            self._freq_est = ItemFrequencyEstimator()
        self.auc = StreamingAUC()
        self.last_logits: Optional[torch.Tensor] = None
        self.pipeline_depth = max(0, run_cfg.pipeline_depth)
        self._pending: deque = deque()
        self._last_loss = self._last_step = None
        self._resized_at = -1
        self.eval_route_drops = 0
        self._live_upper = 0
        self.unique_cap = run_cfg.unique_cap or (run_cfg.batch_size // self.S
                                                 * model_cfg.num_sparse_features)
        self._auto_ucap = run_cfg.unique_cap is None
        self._bag_len = 1
        self.a2a_factor = run_cfg.a2a_factor
        self.a2a_ragged = run_cfg.a2a_ragged

    # --- what a column-sharded subclass changes (`parallel/colsharded.py`) ----
    def _local(self, spec: TableSpec) -> TableSpec:
        """The geometry of the shard this rank holds for the table `spec`."""
        return spec

    @property
    def spec_local(self) -> TableSpec:
        return self._local(self.spec)

    def _lane_slice(self, spec_local: TableSpec):
        """The lanes of a saved row this rank restores (None: all)."""
        return None

    def _full_rows(self, emb_u: torch.Tensor) -> torch.Tensor:
        """The tower's [U, dim] rows from this rank's exchanged rows."""
        return emb_u

    def _own_block(self, g_rows: torch.Tensor) -> torch.Tensor:
        """The part of the rows' gradients that updates this rank's shard."""
        return g_rows

    _g2_mean = None  # the rowwise accumulator's hook (`optim.apply_sparse_grads_ctx`)

    def _dense_lr(self) -> float:
        return optim.scheduled_lr(self.run_cfg, self.step)

    # --- the exchange's geometry ---------------------------------------------
    def _cap(self) -> int:
        """The exchange's capacity at the current unique cap and factor: the
        receiver's rows (ragged) or the rows a (source, destination) pair."""
        if self.a2a_ragged:
            return rg.ragged_recv_cap(self.unique_cap, self.S, self.a2a_factor)
        return st.a2a_capacity(self.unique_cap, self.S, self.a2a_factor)

    def _owner_major(self) -> int:
        """The ragged exchange takes uniques sorted by owner from the dedup."""
        return self.S if self.a2a_ragged and st.exchanging(self.mesh) else 0

    def _maybe_grow_ucap(self, shape) -> None:
        """Bags of L ids a feature need L times the one-hot dedup capacity
        (unless run_cfg.unique_cap fixes it)."""
        L = shape[2] if len(shape) == 3 else 1
        if self._auto_ucap and L != self._bag_len:
            self._bag_len = L
            self.unique_cap = (self.run_cfg.batch_size // self.S
                               * self.model_cfg.num_sparse_features * L)

    def _inputs(self, batch: dict):
        ids = _tensor(batch["ids"], self.device, torch.int64)
        dense = _tensor(batch["dense"], self.device, torch.float32)
        label = _tensor(batch["label"], self.device, torch.float32)
        hi, lo = hashing.split_ids_t(ids)
        omaj = self._owner_major()
        uniq = dedup.unique_pairs(hi.reshape(-1), lo.reshape(-1), self.unique_cap,
                                  owner_major=omaj)
        bag_valid = hashing.is_valid(hi, lo) if ids.dim() == 3 else None
        return ids.shape, dense, label, uniq, bag_valid, batch_item_key(self.model, hi, lo), omaj

    # --- steps ---------------------------------------------------------------
    def train_step(self, batch: dict) -> dict:
        """One step on this rank's rows {"dense", "ids", "label"}. Returns
        {"loss": the global loss of step `step - pipeline_depth` (None while
        the pipeline fills), "retired_step", "in_flight"}."""
        self._maybe_grow_ucap(tuple(batch["ids"].shape))
        self._maybe_grow(int(np.prod(batch["ids"].shape)) * self.S)
        spec, rc, mesh = self.spec_local, self.run_cfg, self.mesh
        shape, dense, label, uniq, bag_valid, ikey, omaj = self._inputs(batch)
        logq = None
        if self._freq_est is not None:
            keys = item_keys_np(_host_ids(batch["ids"]), self.model.qf)
            logq = torch.from_numpy(self._freq_est.update_and_logq(keys)).to(self.device)
        cap = self._cap()
        emb_u, ctx = st.exchange_lookup(spec, self.shard, uniq.hi, uniq.lo, uniq.valid,
                                        self.step, mesh, cap, train=True,
                                        ragged=self.a2a_ragged, owner_sorted=bool(omaj))
        rows_u = self._full_rows(emb_u).detach().requires_grad_(True)
        flat = dedup.GatherRows.apply(rows_u, uniq.inverse, uniq.order, uniq.sorted_ids)
        emb = model_inputs(self.model, flat, shape, bag_valid, self.spec.dim,
                           self.model_cfg.combiner)
        loss, logits = model_loss(self.model, dense, emb, bag_valid, label, ikey, logq=logq)
        # 1/S: the owners' sums and the all-reduce below give the global mean
        loss = loss / self.S
        g_rows, *g_dense = torch.autograd.grad(loss, [rows_u, *self.params])
        with torch.no_grad():
            st.exchange_apply_grads(spec, self.shard, ctx, self._own_block(g_rows), mesh, cap,
                                    g2_mean=self._g2_mean)
            *g_dense, loss, drops = sum_over_ranks([*g_dense, loss, ctx.n_drop], mesh)
            self.opt_state = optim.dense_step(rc, self.params, g_dense, self.opt_state,
                                              self._dense_lr())
        self.step += 1
        self._pending.append({"step": self.step - 1, "loss": loss, "drops": drops,
                              "logits": logits.detach(), "labels": label,
                              "miss": (ctx.miss_hi, ctx.miss_lo, ctx.miss)})
        while len(self._pending) > self.pipeline_depth:
            self._retire(self._pending.popleft())
        return {"loss": self._last_loss, "retired_step": self._last_step,
                "in_flight": len(self._pending)}

    def _retire(self, ent: dict) -> None:
        """Read one finished step's outputs on the host: feed the promoter,
        resize the exchange after route drops, update the AUC."""
        if self._promoter is not None:
            self._promoter.feed(*ent["miss"])
        drops = int(ent["drops"])
        if drops and ent["step"] >= self._resized_at:
            old = self.a2a_factor
            self.a2a_factor = min(self.a2a_factor * 2.0, float(self.S))
            logging.getLogger(__name__).warning(
                "a2a exchange overflowed at step %d (%d ids trained from zero rows); "
                "a2a_factor %g -> %g", ent["step"], drops, old, self.a2a_factor)
            if self.a2a_factor != old:
                self._resized_at = self.step
        self.last_logits = ent["logits"]
        self.auc.update(ent["logits"], ent["labels"])
        self._last_loss = float(ent["loss"])
        self._last_step = ent["step"]

    def flush(self) -> list:
        """Retire every step in flight; returns their (step, loss), oldest
        first."""
        out = []
        while self._pending:
            self._retire(self._pending.popleft())
            out.append((self._last_step, self._last_loss))
        return out

    @torch.no_grad()
    def eval_step(self, batch: dict) -> dict:
        """Probe-only scoring of this rank's labelled rows: nothing is
        inserted, unknown and dropped ids read zero rows. Returns {"loss":
        the mean over ranks, "logits": this rank's, "route_drops": global}."""
        self._maybe_grow_ucap(tuple(batch["ids"].shape))
        shape, dense, label, uniq, bag_valid, ikey, omaj = self._inputs(batch)
        emb_u, ctx = st.exchange_lookup(self.spec_local, self.shard, uniq.hi, uniq.lo,
                                        uniq.valid, 0, self.mesh, self._cap(), train=False,
                                        ragged=self.a2a_ragged, owner_sorted=bool(omaj))
        flat = dedup.GatherRows.apply(self._full_rows(emb_u), uniq.inverse, uniq.order,
                                      uniq.sorted_ids)
        emb = model_inputs(self.model, flat, shape, bag_valid, self.spec.dim,
                           self.model_cfg.combiner)
        loss, logits = model_loss(self.model, dense, emb, bag_valid, label, ikey)
        loss, drops = sum_over_ranks([loss / self.S, ctx.n_drop], self.mesh)
        drops = int(drops)
        self.eval_route_drops += drops
        if drops:
            logging.getLogger(__name__).warning(
                "eval exchange dropped %d ids (scored with zero rows); raise run.a2a_factor",
                drops)
        return {"loss": float(loss), "logits": logits, "route_drops": drops}

    # --- growth and removal -------------------------------------------------
    def _live(self) -> int:
        return int(sum_ints(self.shard.cnt.sum(), self.mesh))

    def _maybe_grow(self, incoming: int) -> None:
        """Double every shard in lockstep when the global live count could
        cross grow_at_load of the global capacity this step. Owners are a
        hash of the key alone, so rows stay on their rank: growth is S
        local rehashes. A host-side upper bound (live grows by at most
        `incoming` a step) gates the all-reduce of the live count, so steps
        far from the threshold pay none."""
        if self.table_cfg.grow_at_load is None:
            return
        self._live_upper += incoming
        if self._live_upper <= self.table_cfg.grow_at_load * self.spec.capacity * self.S:
            return
        while True:
            live = self._live()
            if live + incoming <= self.table_cfg.grow_at_load * self.spec.capacity * self.S:
                self._live_upper = live + incoming
                return
            self.grow()

    def grow(self) -> None:
        """Double the capacity of this rank's shard by a local rehash
        (`regrow_shard`); every rank calls it at the same step."""
        from meepoembedding_tpu_torch.table.runtime import regrow_shard

        old_local = self.spec_local
        self.table_cfg = dataclasses.replace(self.table_cfg,
                                             capacity=self.table_cfg.capacity * 2)
        self.spec = TableSpec.from_config(self.table_cfg, num_shards=self.S)
        self.shard = regrow_shard(old_local, self.spec_local, self.shard, self.step)

    def remove(self, ids64) -> int:
        """Erase keys on their owners (`exchange_erase`). Every rank passes
        the same ids; the owners fold the S copies. Returns the global
        removed count."""
        uniq = np.unique(np.asarray(ids64, np.int64))
        n = max(LANES, 1 << max(0, (len(uniq) - 1).bit_length()))
        ids = np.full((n,), hashing.EMPTY_ID, np.int64)
        ids[:len(uniq)] = uniq
        hi, lo = hashing.split_ids_t(torch.from_numpy(ids).to(self.device))
        removed = st.exchange_erase(self.spec_local, self.shard, hi, lo, hashing.is_valid(hi, lo),
                                    self.mesh, st.a2a_capacity(n, self.S, self.a2a_factor))
        return int(removed)

    # --- maintenance --------------------------------------------------------
    def _apply_promotions(self) -> PromoteStats:
        if self._promoter is None:
            return PromoteStats()
        pst = drain_promotions(self.spec_local, self.shard, self._promoter, self.step)
        # promotions add live rows that train_step's bound did not count
        self._live_upper += int(multihost.all_processes_sum(pst.inserted, self.mesh))
        self.promote_respills += pst.respilled
        return pst

    def maintenance(self) -> dict:
        """Retire the steps in flight (their misses feed the promoter),
        insert the staged promotions, then one eviction pass over the next
        window of this rank's buckets, spilling locally. `evicted` is the
        global count; the promotion figures are this rank's."""
        self.flush()
        pst = self._apply_promotions()
        out = {"evicted": 0, "promoted": pst.inserted, "promote_staged": pst.staged,
               "promote_respilled": pst.respilled}
        if self.spec.policy.evict_policy == "none":
            return out
        off = self._evict_cursor
        self._evict_cursor = table_ops.next_evict_cursor(self.spec_local, off)
        export = table_ops.evict_pass(self.spec_local, self.shard, self.step, off)
        if export.count:
            self._spill(export)
        out["evicted"] = int(multihost.all_processes_sum(export.count, self.mesh))
        return out

    def _spill(self, export) -> None:
        """This rank's evicted rows into its cold tier, if it has one."""
        if self.spill is not None:
            from meepoembedding_tpu_torch.tiering import SpillCodec, spill_export

            spill_export(SpillCodec(self.spec), self.spill, export)
            self.spilled_rows += export.count

    # --- checkpoints ----------------------------------------------------------
    def save_checkpoint(self, path: str, extras: Optional[dict] = None) -> dict:
        """Save in the reference's format over the multi-process protocol:
        each rank writes its shard, rank 0 the tower and the manifest.
        Restorable at any S, and by the single-device trainer."""
        from meepoembedding_tpu_torch import checkpoint

        self.flush()
        coord = self.mesh.rank == 0
        dense = ({"params": to_jax_params(self.model),
                  "opt_state": to_jax_adam_state(self.opt_state, self.model)}
                 if coord else None)
        return checkpoint.save_sharded(
            path, self.spec, {self.mesh.rank: self.shard}, self.S, self.step, extras=extras,
            dense=dense, is_coordinator=coord,
            barrier=lambda name="": multihost.barrier(name, self.mesh))

    def load_checkpoint(self, path: str) -> dict:
        """Elastic restore: a checkpoint of any shard count loads onto S
        ranks, every key rehashed to its owner; each rank builds only its
        shard. A growable table (grow_at_load) first grows to fit the saved
        rows; a fixed one that cannot hold them raises."""
        from meepoembedding_tpu_torch import checkpoint

        m = checkpoint.read_manifest(path)
        total = sum(m.get("counts", [0]))
        cfg, spec = self.table_cfg, self.spec
        while cfg.grow_at_load is not None and total > cfg.grow_at_load * spec.capacity * self.S:
            cfg = dataclasses.replace(cfg, capacity=cfg.capacity * 2)
            spec = TableSpec.from_config(cfg, num_shards=self.S)
        local = self._local(spec)
        checkpoint.check_manifest(local, m, self._lane_slice(local))
        self.shard = None  # free the old planes before the new ones land
        shards, manifest = checkpoint.restore_shards(local, path, self.S, device=self.device,
                                                     only_ids={self.mesh.rank},
                                                     lane_slice=self._lane_slice(local))
        self.table_cfg, self.spec, self.shard = cfg, spec, shards[self.mesh.rank]
        saved = manifest.get("dense", [])
        if "params" in saved:
            from_jax_params(self.model, checkpoint.load_dense(path, "params"))
            self.opt_state = optim.dense_adam_init(self.params)
        if "opt_state" in saved:
            self.opt_state = from_jax_adam_state(checkpoint.load_dense(path, "opt_state"),
                                                 self.model, self.device)
        self.step = manifest["step"]
        # the growth gate starts from the restored rows, not from zero
        self._live_upper = total
        return manifest

    # --- introspection ------------------------------------------------------
    def counters(self) -> dict:
        """The counters summed over the ranks, with the host-side spills and
        re-spilled promotions."""
        self.flush()
        host = torch.tensor([self.spilled_rows, self.promote_respills], device=self.device)
        c = sum_ints(torch.cat([self.shard.counters.to(torch.int64), host]), self.mesh).cpu()
        out = {n: int(c[i]) for i, n in enumerate(SHARDED_COUNTER_NAMES)}
        out["erases"] = int(c[ERASES])
        out["spills"] = max(out["spills"], int(c[-2]))
        out["promote_respills"] = int(c[-1])
        return out

    def __len__(self) -> int:
        return self._live()
