"""Training over a group of heterogeneous tables (port of
`meepoembedding_tpu/group_train.py:1-540`, the single-device
`GroupTrainer`).

One model may own several logical embedding tables with their own dims,
optimizers and policies: user ids at dim 64 with rowwise AdaGrad, item ids
at dim 32 with FTRL, and so on. `GroupTrainer` trains such a group with the
single-table `train.Trainer`'s step: for each member, in sorted name order,
the dedup of its columns -> `table_ops.lookup_train` -> `dedup.GatherRows`
-> pooling; then the head, one `torch.autograd.grad` over every member's
unique rows and the dense params, each member's sparse update
(`optim.apply_sparse_grads_ctx`), grad clipping, the LR schedule and dense
Adam.

Batches: batch["ids"] is [B, S] or [B, S, L] int64, where sparse column s
reads from table `feature_map[s]`. Bags stay padded here (both trainers
pool them with `pooling.pool_or_reshape`): the single-device
`train.Trainer`'s ragged paths (`ops/pooling.py`) are not taken (ROADMAP
queue 5, item 4(a)). Several columns may name one table (the
shared-embedding pattern: a candidate item and the history items share the
item table); their ids dedup together, so an id is gathered and updated
once a step.

Heads (`group_head_init`, `group_head_apply`):
  ctr_mlp  the wide concat MLP: logits = MLP(dense ++ pooled features), the
           family whose input is dim-heterogeneous by construction.
  dlrm     bottom MLP + pairwise dot interaction + top MLP, when every
           referenced table has model.embedding_dim and the bottom MLP ends
           there: the single-table DLRM's function. A dlrm config over a
           group that is not dot-compatible falls back to the wide head with
           a warning, as in the reference. Other kinds are refused.

Maintenance is per member: each has its own evict cursor, spill backend,
`PromotionEngine` and growth gate (`grow_at_load`), so a small hot table can
evict while a large one doubles by rehash. Checkpoints keep the reference's
layout: group.json and one checkpoint a member in table-<name>/, the dense
tower and its Adam state riding the first member.

`ShardedGroupTrainer` (`group_train.py:542-1213` of the reference) row-
shards every member over one mesh of S ranks (`parallel/`): each member
runs its own dedup, `sharded_table.exchange_lookup` (dense, or ragged with
the owner-major dedup under `run.a2a_ragged`) and `exchange_apply_grads`
around one head, whose gradients are summed over the ranks. One process a
rank, each passing its own `batch_size / S` rows, in lockstep.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from meepoembedding_tpu_torch.config import ModelConfig, RunConfig, TableConfig
from meepoembedding_tpu_torch.metrics import StreamingAUC
from meepoembedding_tpu_torch.models.common import DTYPES, MLP, bce_with_logits
from meepoembedding_tpu_torch.models.dlrm import DLRM
from meepoembedding_tpu_torch.ops import dedup, optim, pooling
from meepoembedding_tpu_torch.table import hashing, table_ops
from meepoembedding_tpu_torch.table.group import read_group_json, write_group_json
from meepoembedding_tpu_torch.table.layout import (
    DENIED,
    DROPS,
    EVICTIONS,
    HITS,
    INSERTS,
    MISSES,
    PROMOTES,
    TableSpec,
    alloc_shard,
    resolve_device,
)
from meepoembedding_tpu_torch.train import _tensor
from meepoembedding_tpu_torch.weights import (
    from_jax_adam_state,
    from_jax_params,
    param_leaves,
    to_jax_adam_state,
    to_jax_params,
)


class GroupWideHead(nn.Module):
    """The wide concat head: one ReLU MLP over dense ++ the pooled features
    of every column (dims may differ)."""

    def __init__(self, cfg: ModelConfig, in_dim: int, generator=None):
        super().__init__()
        self.cfg = cfg
        self.mlp = MLP(in_dim, cfg.top_mlp, dtype=DTYPES[cfg.dtype], generator=generator)

    def jax_tree(self) -> dict:
        return {"mlp": self.mlp.jax_tree()}

    def forward(self, dense: torch.Tensor, feats) -> torch.Tensor:
        dt = DTYPES[self.cfg.dtype]
        z = torch.cat([dense.to(dt)] + [f.to(dt) for f in feats], dim=1)
        return self.mlp(z).reshape(-1).to(torch.float32)


class GroupDotHead(DLRM):
    """The DLRM head over a dot-compatible group: the single-table DLRM with
    one sparse feature a column, fed the stacked [B, S, D] features."""

    def forward(self, dense: torch.Tensor, feats) -> torch.Tensor:
        return super().forward(dense, torch.stack(list(feats), dim=1))


def group_head_init(model_cfg: ModelConfig, specs: Dict[str, TableSpec],
                    feature_map: Sequence[str], generator=None) -> nn.Module:
    """The dense head of a group (module docstring), its weights drawn from
    `generator`. Its `jax_tree()` is the reference's {"mlp"} or {"bottom",
    "top"} params tree, so `weights.py` carries params and Adam state."""
    kind = model_cfg.kind or "ctr_mlp"
    if kind not in ("ctr_mlp", "dlrm"):
        raise ValueError(f"group trainers support model.kind ctr_mlp|dlrm, got {kind!r}: "
                         "DIN/BST behaviour sequences and two_tower retrieval train on a "
                         "single table (train.Trainer)")
    if kind == "dlrm":
        dims = {n: specs[n].dim for n in set(feature_map)}
        d = model_cfg.embedding_dim
        if (set(dims.values()) == {d} and model_cfg.bottom_mlp
                and model_cfg.bottom_mlp[-1] == d):
            cfg = dataclasses.replace(model_cfg, num_sparse_features=len(feature_map))
            return GroupDotHead(cfg, generator=generator)
        logging.getLogger(__name__).warning(
            "group model.kind=dlrm but the group is not dot-compatible (dims %s vs "
            "embedding_dim %d, bottom_mlp %s); using the wide concat MLP head", dims, d,
            model_cfg.bottom_mlp)
    in_dim = model_cfg.num_dense_features + sum(specs[fn].dim for fn in feature_map)
    return GroupWideHead(model_cfg, in_dim, generator=generator)


def group_head_apply(model_cfg: ModelConfig, head: nn.Module, dense: torch.Tensor,
                     feats) -> torch.Tensor:
    """feats: per-column pooled embeddings [B, dim_s] in batch-column order
    -> logits [B] f32, differentiable in the head's params and in feats."""
    return head(dense, feats)


class GroupTrainer:
    """Single-device trainer over a group of tables. The head starts from
    `generator` (default: a CPU generator seeded with `run_cfg.seed`), dense
    Adam from zero. `spill` maps member names to `KVBackend`s that
    `maintenance()` spills their evicted rows to and promotes from."""

    S = 1  # shards a member, and this process's shard (`ShardedGroupTrainer`)
    shard_id = 0

    def __init__(self, run_cfg: RunConfig, table_cfgs: Dict[str, TableConfig],
                 feature_map: Sequence[str], model_cfg: ModelConfig,
                 spill: Optional[Dict[str, object]] = None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        if not table_cfgs or not feature_map:
            raise ValueError("need tables and a feature map")
        unknown = set(feature_map) - set(table_cfgs)
        if unknown:
            raise ValueError(f"feature_map names unknown tables: {sorted(unknown)}")
        unused = set(table_cfgs) - set(feature_map)
        if unused:
            raise ValueError(f"tables never referenced by feature_map: {sorted(unused)}")
        for name, cfg in table_cfgs.items():
            if cfg.dim > 128:  # the reference's limit, kept for one contract
                raise ValueError(f"table {name!r}: group members have dim <= 128, got "
                                 f"{cfg.dim}; wider tables train on a single table")
        self.device = resolve_device(device)
        self.run_cfg, self.model_cfg = run_cfg, model_cfg
        self.names = sorted(table_cfgs)
        self.feature_map = list(feature_map)
        self.table_cfgs = dict(table_cfgs)  # growth rebuilds specs from these
        self.specs = {n: TableSpec.from_config(table_cfgs[n], num_shards=self.S)
                      for n in self.names}
        self.shards = {n: alloc_shard(self.specs[n], self.device) for n in self.names}
        self.spill = dict(spill or {})
        self._promoters: Dict[str, object] = {}
        if self.spill:
            from meepoembedding_tpu_torch.tiering import PromotionEngine, SpillCodec

            unknown_spill = set(self.spill) - set(self.names)
            if unknown_spill:
                raise ValueError(f"spill backends for unknown tables: {sorted(unknown_spill)}")
            for n, be in self.spill.items():
                codec = SpillCodec(self.specs[n])
                if be.width != codec.width:
                    raise ValueError(f"table {n!r}: spill backend width {be.width} != codec "
                                     f"{codec.width}")
                self._promoters[n] = PromotionEngine(codec, be)
        self._evict_cursors: Dict[str, int] = {}
        self._live_upper = {n: 0 for n in self.names}
        self.spilled_rows = {n: 0 for n in self.names}
        # the columns each table serves, in batch-column order
        self.table_features = {n: [s for s, fn in enumerate(self.feature_map) if fn == n]
                               for n in self.names}
        self._cols = {n: torch.tensor(c, device=self.device)
                      for n, c in self.table_features.items()}
        gen = generator if generator is not None else torch.Generator().manual_seed(run_cfg.seed)
        self.head = group_head_init(model_cfg, self.specs, self.feature_map, gen).to(self.device)
        # in the reference's flatten order, so the Adam leaves line up
        self.params = [p for p, _ in param_leaves(self.head)]
        self.opt_state = optim.dense_adam_init(self.params)
        self.step = 0
        self.auc = StreamingAUC()
        self.last_logits: Optional[torch.Tensor] = None

    # --- the step -------------------------------------------------------------
    def _caps(self, ids_shape) -> Dict[str, int]:
        """Dedup capacity a table: its columns' id count."""
        per_col = int(np.prod(ids_shape)) // ids_shape[1]
        return {n: max(per_col * len(cols), 1) for n, cols in self.table_features.items()}

    def _inputs(self, batch: dict):
        ids = _tensor(batch["ids"], self.device, torch.int64)
        dense = _tensor(batch["dense"], self.device, torch.float32)
        label = _tensor(batch["label"], self.device, torch.float32)
        hi, lo = hashing.split_ids_t(ids)
        return ids.shape, dense, label, hi, lo

    def _member_ids(self, n: str, hi, lo, caps, owner_major: int = 0):
        """A member's columns, deduplicated together -> (its hi ids, bag validity
        or None, the `Unique`)."""
        h, l = hi.index_select(1, self._cols[n]), lo.index_select(1, self._cols[n])
        uniq = dedup.unique_pairs(h.reshape(-1), l.reshape(-1), caps[n], owner_major=owner_major)
        bag_valid = hashing.is_valid(h, l) if hi.dim() == 3 else None
        return h, bag_valid, uniq

    def _logits(self, dense, per_table: dict) -> torch.Tensor:
        feats = [per_table[fn][:, self.table_features[fn].index(s)]
                 for s, fn in enumerate(self.feature_map)]
        return group_head_apply(self.model_cfg, self.head, dense, feats)

    def train_step(self, batch: dict) -> dict:
        """One step on {"dense": [B, ND], "ids": [B, S] or [B, S, L] int64,
        "label": [B]}. Returns {"loss": float}; the logits stay in
        `last_logits`."""
        rc = self.run_cfg
        self._maybe_grow(batch["ids"])
        shape, dense, label, hi, lo = self._inputs(batch)
        caps = self._caps(shape)
        ctxs, leaves, per_table = {}, [], {}
        for n in self.names:
            spec = self.specs[n]
            h, bag_valid, uniq = self._member_ids(n, hi, lo, caps)
            ctx = table_ops.lookup_train(spec, self.shards[n], uniq.hi, uniq.lo, uniq.valid,
                                         self.step)
            rows_u = ctx.rows_u.detach().requires_grad_(True)
            flat = dedup.GatherRows.apply(rows_u, uniq.inverse, uniq.order, uniq.sorted_ids)
            per_table[n] = pooling.pool_or_reshape(flat, h.shape, bag_valid, spec.dim,
                                                   self.model_cfg.combiner)
            if n in self._promoters:  # the miss set feeds the cold tier's promoter
                self._promoters[n].feed(uniq.hi, uniq.lo, uniq.valid & ~ctx.found)
            ctxs[n] = ctx
            leaves.append(rows_u)
        logits = self._logits(dense, per_table)
        loss = bce_with_logits(logits, label)
        grads = torch.autograd.grad(loss, leaves + self.params)
        with torch.no_grad():
            for n, g in zip(self.names, grads):
                optim.apply_sparse_grads_ctx(self.specs[n], self.shards[n], ctxs[n], g)
            self.opt_state = optim.dense_step(rc, self.params, list(grads[len(self.names):]),
                                              self.opt_state, optim.scheduled_lr(rc, self.step))
        self.step += 1
        self.last_logits = logits.detach()
        self.auc.update(self.last_logits, label)
        return {"loss": float(loss.detach())}

    @torch.no_grad()
    def eval_step(self, batch: dict) -> dict:
        """Probe-only scoring of a labelled batch: unknown ids read zero rows
        and nothing is inserted. Returns {"loss": float, "logits": [B]}."""
        shape, dense, label, hi, lo = self._inputs(batch)
        caps = self._caps(shape)
        per_table = {}
        for n in self.names:
            spec, shard = self.specs[n], self.shards[n]
            h, bag_valid, uniq = self._member_ids(n, hi, lo, caps)
            rows, _ = table_ops.lookup_probe(spec, shard, uniq.hi, uniq.lo, uniq.valid)
            flat = dedup.GatherRows.apply(rows.float(), uniq.inverse, uniq.order,
                                          uniq.sorted_ids)
            per_table[n] = pooling.pool_or_reshape(flat, h.shape, bag_valid, spec.dim,
                                                   self.model_cfg.combiner)
        logits = self._logits(dense, per_table)
        return {"loss": float(bce_with_logits(logits, label)), "logits": logits}

    # --- growth and maintenance, a member at a time -------------------------------
    def _total(self, x: int) -> int:
        """A count of this process's shards over all of them."""
        return x

    def _maybe_grow(self, ids) -> None:
        """Per-member online growth. A member's live count grows by at most
        its columns' id count a step (over every shard), so a host-side
        upper bound gates the device read of its count, as in the
        reference: no read on steps far from the growth point."""
        shape = tuple(ids.shape)
        L = shape[2] if len(shape) == 3 else 1
        for n in self.names:
            cfg = self.table_cfgs[n]
            if cfg.grow_at_load is None:
                continue
            incoming = shape[0] * self.S * L * len(self.table_features[n])
            self._live_upper[n] += incoming
            if self._live_upper[n] <= cfg.grow_at_load * self.specs[n].capacity * self.S:
                continue
            while True:
                live = self._total(int(self.shards[n].cnt.sum()))
                if live + incoming <= cfg.grow_at_load * self.specs[n].capacity * self.S:
                    self._live_upper[n] = live + incoming
                    break
                self._grow_table(n)

    def _grow_table(self, name: str) -> None:
        """Double one member's capacity by rehash (`runtime.regrow_shard`)."""
        from meepoembedding_tpu_torch.table.runtime import regrow_shard

        old_spec = self.specs[name]
        self.table_cfgs[name] = dataclasses.replace(self.table_cfgs[name],
                                                    capacity=old_spec.capacity * self.S * 2)
        self.specs[name] = TableSpec.from_config(self.table_cfgs[name], num_shards=self.S)
        self.shards[name] = regrow_shard(old_spec, self.specs[name], self.shards[name],
                                         self.step)

    def _apply_promotions(self) -> Dict[str, int]:
        """Insert each member's staged cold->hot promotions with their spilled
        state; slot-race losers go back to the cold tier (`respill_failed`)."""
        from meepoembedding_tpu_torch.tiering import respill_failed

        out = {}
        for n, prm in self._promoters.items():
            res = prm.drain()
            if res is None:
                out[n] = 0
                continue
            keys, state = res
            hi, lo = hashing.split_ids(keys)

            def dev(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

            ok = table_ops.insert_rows(
                self.specs[n], self.shards[n], dev(hi), dev(lo), dev(state["values"]),
                torch.ones((len(keys),), dtype=torch.bool, device=self.device), self.step,
                freq=dev(state["freq"]),
                accum=dev(state["accum"]) if "accum" in state else None,
                fulldim=[dev(f) for f in state["fulldim"]] or None,
            )
            resp = respill_failed(prm, keys, state, ok)
            # promoted rows are live rows the growth gate never counted
            self._live_upper[n] += len(keys) - resp
            out[n] = len(keys) - resp
        return out

    def maintenance(self) -> Dict[str, dict]:
        """The eviction tick of every member: promotions drained first, then
        one `evict_pass` over each evicting member's next window, its rows
        spilled to its backend when it has one."""
        promoted = self._apply_promotions()
        out = {}
        for n in self.names:
            spec = self.specs[n]
            if spec.policy.evict_policy == "none":
                out[n] = {"evicted": 0, "promoted": promoted.get(n, 0)}
                continue
            off = self._evict_cursors.get(n, 0)
            self._evict_cursors[n] = table_ops.next_evict_cursor(spec, off)
            export = table_ops.evict_pass(spec, self.shards[n], self.step, off)
            cnt = export.count
            if cnt and n in self.spill:
                from meepoembedding_tpu_torch.tiering import SpillCodec, spill_export

                spill_export(SpillCodec(spec), self.spill[n], export)
                self.spilled_rows[n] += cnt
            out[n] = {"evicted": self._total(cnt), "promoted": promoted.get(n, 0)}
        return out

    def remove(self, name: str, ids64) -> int:
        """Remove keys from one member (absent keys are a no-op); returns how
        many were removed."""
        uniq = np.unique(np.asarray(ids64, np.int64))
        hi, lo = (torch.from_numpy(a).to(self.device) for a in hashing.split_ids(uniq))
        found = table_ops.erase_keys(self.specs[name], self.shards[name], hi, lo,
                                     hashing.is_valid(hi, lo))
        return int(found.sum())

    def counters(self) -> Dict[str, dict]:
        """The reference's per-member counters, and `drops`."""
        out = {}
        for n in self.names:
            c = self.shards[n].counters.cpu().numpy()
            prm = self._promoters.get(n)
            out[n] = {
                "hits": int(c[HITS]), "misses": int(c[MISSES]), "inserts": int(c[INSERTS]),
                "evictions": int(c[EVICTIONS]), "denied": int(c[DENIED]),
                "spills": self.spilled_rows[n],
                "promotes": prm.promoted if prm is not None else 0,
                "promote_respills": prm.respilled if prm is not None else 0,
                "rows": int(self.shards[n].cnt.sum()),
                "capacity": self.specs[n].capacity,
                "drops": int(c[DROPS]),
            }
        return out

    # --- checkpoints (the TableGroup layout and the dense tower) ----------------
    def save_checkpoint(self, path: str) -> dict:
        from meepoembedding_tpu_torch import checkpoint

        os.makedirs(path, exist_ok=True)
        manifest = {"tables": {}, "feature_map": self.feature_map, "step": self.step}
        for i, n in enumerate(self.names):
            dense = None
            if i == 0:  # the dense tower rides the first member
                dense = {"params": to_jax_params(self.head),
                         "opt_state": to_jax_adam_state(self.opt_state, self.head)}
            checkpoint.save(os.path.join(path, f"table-{n}"), self.specs[n], [self.shards[n]],
                            self.step, dense=dense)
            manifest["tables"][n] = f"table-{n}"
        write_group_json(path, manifest)
        return manifest

    def load_checkpoint(self, path: str) -> dict:
        """Restore every member, the head and its Adam state. A growable
        member first grows to fit its checkpoint's live rows, and its growth
        gate starts from them."""
        from meepoembedding_tpu_torch import checkpoint

        manifest = read_group_json(path, self.names)
        for i, n in enumerate(self.names):
            sub = os.path.join(path, manifest["tables"][n])
            m = checkpoint.read_manifest(sub)
            total = sum(m.get("counts", [0]))
            cfg, spec = self.table_cfgs[n], self.specs[n]
            while (cfg.grow_at_load is not None
                   and total > cfg.grow_at_load * spec.capacity * self.S):
                cfg = dataclasses.replace(cfg, capacity=spec.capacity * self.S * 2)
                spec = TableSpec.from_config(cfg, num_shards=self.S)
            checkpoint.check_manifest(spec, m)  # before the old planes go
            self.shards[n] = None
            shards, m = checkpoint.restore_shards(spec, sub, self.S, device=self.device,
                                                  only_ids={self.shard_id})
            self.table_cfgs[n], self.specs[n] = cfg, spec
            self.shards[n] = shards[self.shard_id]
            self._live_upper[n] = total
            if i == 0 and "params" in m.get("dense", []):
                from_jax_params(self.head, checkpoint.load_dense(sub, "params"))
                self.opt_state = from_jax_adam_state(checkpoint.load_dense(sub, "opt_state"),
                                                     self.head, self.device)
        self.step = manifest["step"]
        return manifest


class ShardedGroupTrainer(GroupTrainer):
    """`GroupTrainer` with every member row-sharded over `mesh` (default:
    the world on `device`). A step, for each member in name order: its
    dedup, the exchange to the members' owners and the rows back; then the
    head on this rank's rows with its loss divided by S; each member's
    gradients back to their owners; one all-reduce of the head's gradients
    with the loss and the route drops; clip, the LR schedule and dense Adam.

    As `ShardedTrainer`: `pipeline_depth` lags the loss (`flush()` retires
    the rest), route drops double `a2a_factor` up to S, and `spill` is this
    rank's cold tier a member, fed the owner-side misses and drained at
    `maintenance()`. Counters and `evicted` are global; `promoted` is too."""

    def __init__(self, run_cfg: RunConfig, table_cfgs: Dict[str, TableConfig],
                 feature_map: Sequence[str], model_cfg: ModelConfig, mesh=None,
                 spill: Optional[Dict[str, object]] = None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        from collections import deque

        from meepoembedding_tpu_torch.parallel.mesh import make_mesh

        self.mesh = mesh or make_mesh(device=device)
        self.S, self.shard_id = self.mesh.size, self.mesh.rank
        if run_cfg.batch_size % self.S:
            raise ValueError(f"global batch {run_cfg.batch_size} does not split over "
                             f"{self.S} ranks")
        super().__init__(run_cfg, table_cfgs, feature_map, model_cfg, spill=spill,
                         device=self.mesh.device, generator=generator)
        self.a2a_factor = run_cfg.a2a_factor
        self.a2a_ragged = run_cfg.a2a_ragged
        self.pipeline_depth = max(0, run_cfg.pipeline_depth)
        self._pending: deque = deque()
        self._last_loss = self._last_step = None
        self._resized_at = -1
        self.eval_route_drops = 0
        self.promote_respills = {n: 0 for n in self.names}

    def _total(self, x: int) -> int:
        from meepoembedding_tpu_torch.parallel.trainer import sum_ints

        return int(sum_ints(torch.tensor(x, device=self.device), self.mesh))

    def _exchange_caps(self, caps: Dict[str, int]) -> Dict[str, int]:
        """The exchange's capacity a member at its dedup capacity."""
        from meepoembedding_tpu_torch.parallel import ragged as rg
        from meepoembedding_tpu_torch.parallel import sharded_table as st

        f = rg.ragged_recv_cap if self.a2a_ragged else st.a2a_capacity
        return {n: f(c, self.S, self.a2a_factor) for n, c in caps.items()}

    def _lookups(self, batch: dict, train: bool):
        """Every member's dedup and exchange of this rank's rows ->
        (dense, label, the pooled features a member, the leaves of the
        rows, their ctxs, the exchange caps, the route drops tensor)."""
        from meepoembedding_tpu_torch.parallel import sharded_table as st

        shape, dense, label, hi, lo = self._inputs(batch)
        caps = self._caps(shape)
        xcaps = self._exchange_caps(caps)
        omaj = self.S if self.a2a_ragged and st.exchanging(self.mesh) else 0
        per_table, leaves, ctxs, drops = {}, [], {}, []
        for n in self.names:
            spec = self.specs[n]
            h, bag_valid, uniq = self._member_ids(n, hi, lo, caps, owner_major=omaj)
            emb_u, ctx = st.exchange_lookup(spec, self.shards[n], uniq.hi, uniq.lo, uniq.valid,
                                            self.step if train else 0, self.mesh, xcaps[n],
                                            train=train, ragged=self.a2a_ragged,
                                            owner_sorted=bool(omaj))
            rows_u = emb_u.detach().requires_grad_(train)
            flat = dedup.GatherRows.apply(rows_u, uniq.inverse, uniq.order, uniq.sorted_ids)
            per_table[n] = pooling.pool_or_reshape(flat, h.shape, bag_valid, spec.dim,
                                                   self.model_cfg.combiner)
            leaves.append(rows_u)
            ctxs[n] = ctx
            drops.append(ctx.n_drop)
        return dense, label, per_table, leaves, ctxs, xcaps, torch.stack(drops).sum()

    def train_step(self, batch: dict) -> dict:
        """One step on this rank's rows. Returns {"loss": the global loss of
        step `step - pipeline_depth` (None while the pipeline fills),
        "retired_step", "in_flight"}."""
        from meepoembedding_tpu_torch.parallel import sharded_table as st
        from meepoembedding_tpu_torch.parallel.trainer import sum_over_ranks

        rc = self.run_cfg
        self._maybe_grow(batch["ids"])
        dense, label, per_table, leaves, ctxs, xcaps, drops = self._lookups(batch, True)
        logits = self._logits(dense, per_table)
        # 1/S: the owners' sums and the all-reduce below give the global mean
        loss = bce_with_logits(logits, label) / self.S
        grads = torch.autograd.grad(loss, leaves + self.params)
        with torch.no_grad():
            for n, g in zip(self.names, grads):
                st.exchange_apply_grads(self.specs[n], self.shards[n], ctxs[n], g, self.mesh,
                                        xcaps[n])
            *g_dense, loss, drops = sum_over_ranks([*grads[len(self.names):], loss, drops],
                                                   self.mesh)
            self.opt_state = optim.dense_step(rc, self.params, g_dense, self.opt_state,
                                              optim.scheduled_lr(rc, self.step))
        self.step += 1
        self._pending.append({
            "step": self.step - 1, "loss": loss, "drops": drops, "logits": logits.detach(),
            "labels": label,
            "miss": {n: (ctxs[n].miss_hi, ctxs[n].miss_lo, ctxs[n].miss)
                     for n in self._promoters}})
        while len(self._pending) > self.pipeline_depth:
            self._retire(self._pending.popleft())
        return {"loss": self._last_loss, "retired_step": self._last_step,
                "in_flight": len(self._pending)}

    def _retire(self, ent: dict) -> None:
        """Read one finished step on the host: feed the promoters, resize the
        exchange after route drops, update the AUC."""
        for n, prm in self._promoters.items():
            prm.feed(*ent["miss"][n])
        drops = int(ent["drops"])
        if drops and ent["step"] >= self._resized_at:
            old = self.a2a_factor
            self.a2a_factor = min(self.a2a_factor * 2.0, float(self.S))
            logging.getLogger(__name__).warning(
                "group a2a exchange overflowed at step %d (%d ids); a2a_factor %g -> %g",
                ent["step"], drops, old, self.a2a_factor)
            if self.a2a_factor != old:
                self._resized_at = self.step
        self.last_logits = ent["logits"]
        self.auc.update(ent["logits"], ent["labels"])
        self._last_loss = float(ent["loss"])
        self._last_step = ent["step"]

    def flush(self) -> list:
        """Retire every step in flight; returns their (step, loss)."""
        out = []
        while self._pending:
            self._retire(self._pending.popleft())
            out.append((self._last_step, self._last_loss))
        return out

    @torch.no_grad()
    def eval_step(self, batch: dict) -> dict:
        """Probe-only scoring of this rank's labelled rows. Returns {"loss":
        the mean over ranks, "logits": this rank's, "route_drops": global}."""
        from meepoembedding_tpu_torch.parallel.trainer import sum_over_ranks

        dense, label, per_table, _, _, _, drops = self._lookups(batch, False)
        logits = self._logits(dense, per_table)
        loss, drops = sum_over_ranks([bce_with_logits(logits, label) / self.S, drops],
                                     self.mesh)
        drops = int(drops)
        self.eval_route_drops += drops
        return {"loss": float(loss), "logits": logits, "route_drops": drops}

    # --- maintenance and removal ------------------------------------------------
    def _apply_promotions(self) -> Dict[str, int]:
        """Each member's staged promotions into this rank's shard
        (`trainer.drain_promotions`); the inserted counts are global."""
        from meepoembedding_tpu_torch.parallel.trainer import drain_promotions

        out = {}
        for n, prm in self._promoters.items():
            pst = drain_promotions(self.specs[n], self.shards[n], prm, self.step)
            g = self._total(pst.inserted)
            self._live_upper[n] += g
            self.promote_respills[n] += pst.respilled
            out[n] = g
        return out

    def maintenance(self) -> Dict[str, dict]:
        self.flush()  # the steps in flight feed the promoters first
        return super().maintenance()

    def remove(self, name: str, ids64) -> int:
        """Erase keys of one member on their owners (`exchange_erase`). Every
        rank passes the same ids; returns the global removed count."""
        from meepoembedding_tpu_torch.config import LANES
        from meepoembedding_tpu_torch.parallel import sharded_table as st

        self.flush()
        uniq = np.unique(np.asarray(ids64, np.int64))
        n = max(LANES, 1 << max(0, (len(uniq) - 1).bit_length()))
        ids = np.full((n,), hashing.EMPTY_ID, np.int64)
        ids[:len(uniq)] = uniq
        hi, lo = hashing.split_ids_t(torch.from_numpy(ids).to(self.device))
        return int(st.exchange_erase(self.specs[name], self.shards[name], hi, lo,
                                     hashing.is_valid(hi, lo), self.mesh,
                                     st.a2a_capacity(n, self.S, self.a2a_factor)))

    def counters(self) -> Dict[str, dict]:
        """Each member's counters summed over the ranks; `capacity` is the
        member's over every shard."""
        from meepoembedding_tpu_torch.parallel.trainer import sum_ints

        self.flush()
        host = [[self.spilled_rows[n], self.promote_respills[n]] for n in self.names]
        flat = torch.cat([torch.cat([self.shards[n].counters.to(torch.int64),
                                     self.shards[n].cnt.sum().reshape(1).to(torch.int64),
                                     torch.tensor(host[i], device=self.device)])
                          for i, n in enumerate(self.names)])
        c = sum_ints(flat, self.mesh).cpu().numpy().reshape(len(self.names), -1)
        out = {}
        for i, n in enumerate(self.names):
            ci = c[i]
            out[n] = {
                "hits": int(ci[HITS]), "misses": int(ci[MISSES]), "inserts": int(ci[INSERTS]),
                "evictions": int(ci[EVICTIONS]), "denied": int(ci[DENIED]),
                "spills": int(ci[-2]), "promotes": int(ci[PROMOTES]),
                "promote_respills": int(ci[-1]), "rows": int(ci[-3]),
                "capacity": self.specs[n].capacity * self.S, "drops": int(ci[DROPS]),
            }
        return out

    # --- checkpoints ----------------------------------------------------------------
    def save_checkpoint(self, path: str) -> dict:
        """The reference's group layout over the multi-process protocol: each
        member's checkpoint written by every rank (its shard), the head on
        the first member by rank 0, then group.json by rank 0. Restorable at
        any S and by `GroupTrainer`."""
        from meepoembedding_tpu_torch import checkpoint
        from meepoembedding_tpu_torch.parallel import multihost

        self.flush()
        coord = self.shard_id == 0
        os.makedirs(path, exist_ok=True)
        manifest = {"tables": {}, "feature_map": self.feature_map, "step": self.step,
                    "num_shards": self.S}
        for i, n in enumerate(self.names):
            dense = None
            if i == 0 and coord:  # the dense tower rides the first member
                dense = {"params": to_jax_params(self.head),
                         "opt_state": to_jax_adam_state(self.opt_state, self.head)}
            checkpoint.save_sharded(
                os.path.join(path, f"table-{n}"), self.specs[n], {self.shard_id: self.shards[n]},
                self.S, self.step, dense=dense, is_coordinator=coord,
                barrier=lambda name="": multihost.barrier(name, self.mesh))
            manifest["tables"][n] = f"table-{n}"
        if coord:
            write_group_json(path, manifest)
        multihost.barrier("group-ckpt-committed", self.mesh)
        return manifest
