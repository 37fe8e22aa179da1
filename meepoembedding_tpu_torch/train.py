"""Single-device training (port of `meepoembedding_tpu/train.py:33-302`).

One step: dedup the batch's ids -> `table_ops.lookup_train` (probe,
admission, insert planning, fresh keys' side-plane writes; the rows of the
unique ids, fresh ones at their init) -> the rows in batch order through
`dedup.GatherRows` (K2 forward; K1 segment sum backward, on the dedup's own
sort) -> the model's forward and loss (`models.common.model_loss`: BCE, or
the two-tower's in-batch softmax with its item keys and, with
`ModelConfig.logq_correction`, the host's log-q estimate) -> backward ->
the sparse update (`optim.apply_sparse_grads_ctx`: the values plane
receives init + optimizer delta in one unique-row K1 launch, the rowwise
accumulator one K3 launch) -> dense grad clip, LR schedule and the
reference's Adam. The table is updated in place. The step syncs with the
host once per insert-planning round (`table_ops.plan_insert` stops when no
key is pending) and once more to read the loss. Between steps,
`maintenance()` evicts (spilling to a `KVBackend`) and `save_checkpoint`
writes the reference's format, synchronously or from a host snapshot on a
background thread.

One path serves every dim: the values plane is row-major, so the
reference's 128-lane window rows (dim <= 128) and its `find_or_insert` path
(dim > 128) are both this one.

  >>> tr = Trainer(RunConfig(batch_size=256), TableConfig(dim=16), ModelConfig(...),
  ...              device="cpu")
  >>> tr.train_step({"dense": d, "ids": ids, "label": y})   # {"loss": ...}
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from meepoembedding_tpu_torch.config import ModelConfig, RunConfig, TableConfig
from meepoembedding_tpu_torch.metrics import JsonlLogger, Meter, StreamingAUC
from meepoembedding_tpu_torch.models import build_model
from meepoembedding_tpu_torch.models.common import batch_item_key, model_inputs, model_loss
from meepoembedding_tpu_torch.ops import dedup, optim
from meepoembedding_tpu_torch.ops.itemfreq import ItemFrequencyEstimator, item_keys_np
from meepoembedding_tpu_torch.table import hashing, table_ops
from meepoembedding_tpu_torch.table.layout import (
    TableShard,
    TableSpec,
    alloc_shard,
    resolve_device,
)
from meepoembedding_tpu_torch.tracing import span
from meepoembedding_tpu_torch.weights import (
    from_jax_adam_state,
    from_jax_params,
    param_leaves,
    to_jax_adam_state,
    to_jax_params,
)

COUNTER_NAMES = ("hits", "misses", "inserts", "drops", "evictions", "spills",
                 "promotes", "denied")


def _host_ids(ids) -> np.ndarray:
    return ids.cpu().numpy() if isinstance(ids, torch.Tensor) else np.asarray(ids, np.int64)


def _tensor(x, device, dtype) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device=device, dtype=dtype)


class Trainer:
    """Single-device trainer. The tower starts He-initialised from
    `generator` (default: a CPU generator seeded with `run_cfg.seed`; the
    same seed gives the same tower on every device), dense Adam from zero.
    `shard` starts the trainer on an existing table shard of the same
    geometry, which it then updates in place. `spill` is an optional
    `KVBackend` that `maintenance()` spills evicted rows to.
    `model_cfg.logq_correction` needs a retrieval model (`two_tower`): each
    step then subtracts the item-frequency sketch's log q from the
    in-batch softmax's columns."""

    def __init__(self, run_cfg: RunConfig, table_cfg: TableConfig, model_cfg: ModelConfig,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 shard: Optional[TableShard] = None, spill=None):
        if model_cfg.embedding_dim != table_cfg.dim:
            raise ValueError(f"model embedding_dim {model_cfg.embedding_dim} != "
                             f"table dim {table_cfg.dim}")
        self.device = resolve_device(device)
        self.run_cfg, self.table_cfg, self.model_cfg = run_cfg, table_cfg, model_cfg
        self.spec = TableSpec.from_config(table_cfg, num_shards=1)
        if shard is None:
            shard = alloc_shard(self.spec, self.device)
        elif tuple(shard.values.shape) != (self.spec.capacity, self.spec.dim):
            raise ValueError(f"shard values {tuple(shard.values.shape)} do not match the "
                             f"table's [{self.spec.capacity}, {self.spec.dim}]")
        self.shard = shard
        gen = generator if generator is not None else torch.Generator().manual_seed(run_cfg.seed)
        self.model = build_model(model_cfg, generator=gen).to(self.device)
        # in the reference's flatten order, so the Adam leaves line up
        self.params = [p for p, _ in param_leaves(self.model)]
        self.opt_state = optim.dense_adam_init(self.params)
        self.step = 0
        self.spill = spill
        self.spilled_rows = 0
        self._evict_cursor = 0
        self._async_ckpt = None
        self.auc = StreamingAUC()
        self.last_logits: Optional[torch.Tensor] = None
        self._freq_est = None
        if model_cfg.logq_correction:
            if not hasattr(self.model, "loss_and_logits"):
                raise ValueError("model.logq_correction needs a retrieval model (two_tower), "
                                 f"not {model_cfg.kind!r}")
            self._freq_est = ItemFrequencyEstimator()

    def _unique_cap(self, ids_shape) -> int:
        return self.run_cfg.unique_cap or int(np.prod(ids_shape))

    def _inputs(self, batch: dict):
        with span("meepo.train.inputs"):
            ids = _tensor(batch["ids"], self.device, torch.int64)
            dense = _tensor(batch["dense"], self.device, torch.float32)
            label = _tensor(batch["label"], self.device, torch.float32)
        hi, lo = hashing.split_ids_t(ids)
        uniq = dedup.unique_pairs(hi.reshape(-1), lo.reshape(-1), self._unique_cap(ids.shape))
        # multi-hot bags ([B, S, L] ids, sentinel-padded) pool per feature
        bag_valid = hashing.is_valid(hi, lo) if ids.dim() == 3 else None
        ikey = batch_item_key(self.model, hi, lo)
        return ids.shape, dense, label, uniq, bag_valid, ikey

    def train_step(self, batch: dict) -> dict:
        """One step on a batch {"dense": [B, ND], "ids": [B, S] or [B, S, L]
        int64, "label": [B]}. Returns {"loss": float}; the step's logits stay
        in `last_logits`."""
        with span("meepo.train.step"):
            return self._train_step(batch)

    def _train_step(self, batch: dict) -> dict:
        spec, rc = self.spec, self.run_cfg
        shape, dense, label, uniq, bag_valid, ikey = self._inputs(batch)
        logq = None
        if self._freq_est is not None:
            keys = item_keys_np(_host_ids(batch["ids"]), self.model.qf)
            logq = torch.from_numpy(self._freq_est.update_and_logq(keys)).to(self.device)
        ctx = table_ops.lookup_train(spec, self.shard, uniq.hi, uniq.lo, uniq.valid, self.step)
        rows_u = ctx.rows_u.detach().requires_grad_(True)
        flat = dedup.GatherRows.apply(rows_u, uniq.inverse, uniq.order, uniq.sorted_ids)
        with span("meepo.tower.forward"):
            emb = model_inputs(self.model, flat, shape, bag_valid, spec.dim,
                               self.model_cfg.combiner)
            loss, logits = model_loss(self.model, dense, emb, bag_valid, label, ikey, logq=logq)
        with span("meepo.tower.backward"):
            g_rows, *g_dense = torch.autograd.grad(loss, [rows_u, *self.params])
        with torch.no_grad():
            optim.apply_sparse_grads_ctx(spec, self.shard, ctx, g_rows)
            with span("meepo.tower.update"):
                if rc.grad_clip_norm is not None:
                    g_dense = optim.clip_by_global_norm(g_dense, rc.grad_clip_norm)
                lr = optim.schedule_lr(rc.lr_schedule, rc.dense_learning_rate, self.step,
                                       rc.steps, rc.warmup_steps)
                self.opt_state = optim.dense_adam_update(self.params, g_dense, self.opt_state,
                                                         lr)
        self.step += 1
        with span("meepo.train.metrics"):
            self.last_logits = logits.detach()
            self.auc.update(self.last_logits, label)
        with span("meepo.train.loss_sync"):
            return {"loss": float(loss.detach())}

    @torch.no_grad()
    def eval_step(self, batch: dict) -> dict:
        """Probe-only scoring of a labelled batch: unknown ids read zero rows
        and nothing is inserted. Returns {"loss": float, "logits": [B]}."""
        spec = self.spec
        shape, dense, label, uniq, bag_valid, ikey = self._inputs(batch)
        pr = table_ops.probe(spec, self.shard, uniq.hi, uniq.lo, uniq.valid)
        rows = table_ops.lookup_rows(self.shard, torch.where(pr.found, pr.slot, -1))
        flat = dedup.GatherRows.apply(rows.float(), uniq.inverse, uniq.order,
                                      uniq.sorted_ids)
        emb = model_inputs(self.model, flat, shape, bag_valid, spec.dim, self.model_cfg.combiner)
        loss, logits = model_loss(self.model, dense, emb, bag_valid, label, ikey)
        return {"loss": float(loss), "logits": logits}

    def counters(self) -> dict:
        c = self.shard.counters.cpu().numpy()
        out = {n: int(c[i]) for i, n in enumerate(COUNTER_NAMES)}
        # spilling runs on the host, so the device counter never sees it
        out["spills"] = max(out["spills"], self.spilled_rows)
        return out

    # --- checkpoints ----------------------------------------------------------
    def _dense(self) -> dict:
        """The tower and its Adam state as the reference's pytree leaves
        (host copies)."""
        return {"params": to_jax_params(self.model),
                "opt_state": to_jax_adam_state(self.opt_state, self.model)}

    def save_checkpoint(self, path: str, extras: Optional[dict] = None,
                        async_: bool = False) -> dict:
        """Save the table, the tower and its Adam state in the reference's
        format. `async_=True` takes the snapshot on the host here and
        returns, while a background thread writes the files
        (`checkpoint.AsyncCheckpointer`); a save in flight is always joined
        first, so async and sync saves to one directory serialize."""
        from meepoembedding_tpu_torch import checkpoint

        if async_:
            if self._async_ckpt is None:
                self._async_ckpt = checkpoint.AsyncCheckpointer()
            self._async_ckpt.save(path, self.spec, [self.shard], self.step,
                                  extras=extras, dense=self._dense())
            return {"async": True, "step": self.step}
        self.finish_saves()
        return checkpoint.save(path, self.spec, [self.shard], self.step, extras=extras,
                               dense=self._dense())

    def finish_saves(self) -> None:
        """Join the async save in flight, if any; re-raises its failure."""
        if self._async_ckpt is not None:
            self._async_ckpt.wait()

    def load_checkpoint(self, path: str) -> dict:
        """Restore the table, the tower and (when saved) its Adam state from
        a checkpoint in the reference's format. A checkpoint of another dim
        or optimizer raises before the old planes are dropped, so the
        trainer keeps its table."""
        from meepoembedding_tpu_torch import checkpoint

        checkpoint.check_manifest(self.spec, checkpoint.read_manifest(path))
        self.shard = None  # free the old planes before the new ones land
        shards, manifest = checkpoint.restore_shards(self.spec, path, 1, device=self.device)
        self.shard = shards[0]
        saved = manifest.get("dense", [])
        if "params" in saved:
            from_jax_params(self.model, checkpoint.load_dense(path, "params"))
            self.opt_state = optim.dense_adam_init(self.params)
        if "opt_state" in saved:
            self.opt_state = from_jax_adam_state(checkpoint.load_dense(path, "opt_state"),
                                                 self.model, self.device)
        self.step = manifest["step"]
        return manifest

    def maintenance(self) -> dict:
        """The eviction tick, off the step's path: one `evict_pass` over the
        next window of buckets, the evicted rows (value, freq and optimizer
        state) spilled to `spill` when there is one."""
        if self.spec.policy.evict_policy == "none":
            return {"evicted": 0}
        off = self._evict_cursor
        self._evict_cursor = table_ops.next_evict_cursor(self.spec, off)
        export = table_ops.evict_pass(self.spec, self.shard, self.step, off)
        n = export.count
        if n and self.spill is not None:
            from meepoembedding_tpu_torch.tiering import SpillCodec, spill_export

            spill_export(SpillCodec(self.spec), self.spill, export)
            self.spilled_rows += n
        return {"evicted": n}


def train(run_cfg: RunConfig, table_cfg: TableConfig, model_cfg: ModelConfig, stream,
          logger: Optional[JsonlLogger] = None, maintenance_every: int = 50,
          spill=None, eval_stream=None, ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
          device="cuda") -> Trainer:
    """Run `run_cfg.steps` training steps from a batch iterator, with an
    eviction tick every `maintenance_every` steps (spilling to `spill`) and
    an async checkpoint to `ckpt_dir` every `ckpt_every` steps; the last
    save is joined before returning. With run_cfg.eval_every > 0 and an
    `eval_stream`, a held-out batch is scored (probe-only) every eval_every
    steps and logged as eval_loss/eval_auc."""
    logger = logger or JsonlLogger(echo=True)
    tr = Trainer(run_cfg, table_cfg, model_cfg, device=device, spill=spill)
    loss_m = Meter()
    t0 = time.perf_counter()
    examples = 0
    eval_iter = None
    if run_cfg.eval_every and eval_stream is not None:
        eval_iter = (eval_stream.batches(run_cfg.steps) if hasattr(eval_stream, "batches")
                     else iter(eval_stream))
    for i, batch in enumerate(stream.batches(run_cfg.steps)):
        out = tr.train_step(batch)
        loss_m.update(out["loss"])
        examples += len(batch["label"])
        if maintenance_every and (i + 1) % maintenance_every == 0:
            tr.maintenance()
        if ckpt_dir and ckpt_every and (i + 1) % ckpt_every == 0:
            # the step loop pays only the snapshot
            tr.save_checkpoint(ckpt_dir, async_=True)
        if eval_iter is not None and (i + 1) % run_cfg.eval_every == 0:
            eb = next(eval_iter, None)
            if eb is None:
                eval_iter = None
            else:
                ev = tr.eval_step(eb)
                ea = StreamingAUC()
                ea.update(ev["logits"], eb["label"])
                logger.log(step=tr.step, eval_loss=ev["loss"], eval_auc=ea.compute())
        if (i + 1) % run_cfg.log_every == 0:
            dt = time.perf_counter() - t0
            logger.log(step=tr.step, loss=loss_m.mean, auc=tr.auc.compute(),
                       examples_per_sec=examples / dt,
                       **{f"ctr_{k}": v for k, v in tr.counters().items()})
    tr.finish_saves()
    return tr
