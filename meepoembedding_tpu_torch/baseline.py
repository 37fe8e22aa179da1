"""The static fixed-vocab embedding baseline of the AUC-parity gate (port of
`meepoembedding_tpu/baseline.py`).

The classic hash-trick embedding: a dense [vocab, dim] table addressed by
`hash(id) % vocab` (collisions and all), trained with rowwise AdaGrad,
beside the dynamic trainer's models, dense Adam and loss, so that the only
difference between the two trainers is the embedding store.

The reference gathers with `jnp.take`, takes autodiff's dense whole-table
gradient and updates the whole table with rowwise AdaGrad, outside any
Pallas kernel; this port does the same with plain PyTorch ops
(`index_select`, its dense gradient, one whole-table update). A row that no
id touched gets a zero gradient, so its value and accumulator keep their
bits.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from meepoembedding_tpu_torch.config import ModelConfig, RunConfig
from meepoembedding_tpu_torch.metrics import StreamingAUC
from meepoembedding_tpu_torch.models import build_model
from meepoembedding_tpu_torch.models.common import bce_with_logits
from meepoembedding_tpu_torch.ops import optim
from meepoembedding_tpu_torch.table import hashing
from meepoembedding_tpu_torch.table.layout import resolve_device
from meepoembedding_tpu_torch.weights import param_leaves


class StaticEmbeddingTrainer:
    """Fixed-vocab (power-of-two) hash-trick embedding + rowwise AdaGrad.
    The table (uniform in +-initializer_scale) and then the tower are drawn
    from `generator` (default: a CPU generator seeded with `run_cfg.seed`);
    the accumulator starts at `initial_accumulator`."""

    def __init__(self, run_cfg: RunConfig, model_cfg: ModelConfig, vocab_size: int,
                 table_lr: float = 0.05, initializer_scale: float = 0.01,
                 initial_accumulator: float = 0.1, eps: float = 1e-8, device="cuda",
                 generator: Optional[torch.Generator] = None):
        if vocab_size <= 0 or vocab_size & (vocab_size - 1):
            raise ValueError(f"vocab must be a power of two, got {vocab_size}")
        self.device = resolve_device(device)
        self.run_cfg, self.model_cfg = run_cfg, model_cfg
        self.vocab = vocab_size
        self.table_lr, self.eps = table_lr, eps
        gen = generator if generator is not None else torch.Generator().manual_seed(run_cfg.seed)
        dim = model_cfg.embedding_dim
        table = (torch.rand((vocab_size, dim), generator=gen) * 2.0 - 1.0) * initializer_scale
        self.table = table.to(self.device)
        self.accum = torch.full((vocab_size,), initial_accumulator, dtype=torch.float32,
                                device=self.device)
        self.model = build_model(model_cfg, generator=gen).to(self.device)
        self.params = [p for p, _ in param_leaves(self.model)]
        self.opt_state = optim.dense_adam_init(self.params)
        self.auc = StreamingAUC()
        self.step = 0

    def _inputs(self, batch: dict):
        ids = torch.from_numpy(np.ascontiguousarray(batch["ids"], np.int64)).to(self.device)
        hi, lo = hashing.split_ids_t(ids)
        idx = hashing.hash_pair(hi.reshape(-1), lo.reshape(-1), hashing.SALT_BUCKET) & (
            self.vocab - 1)
        dense = torch.from_numpy(np.asarray(batch["dense"], np.float32)).to(self.device)
        label = torch.from_numpy(np.asarray(batch["label"], np.float32)).to(self.device)
        return ids.shape, idx, dense, label

    def _loss(self, table, shape, idx, dense, label):
        emb = table.index_select(0, idx).reshape(*shape, -1)
        logits = self.model(dense, emb)
        return bce_with_logits(logits, label), logits

    def train_step(self, batch: dict) -> dict:
        shape, idx, dense, label = self._inputs(batch)
        table = self.table.detach().requires_grad_(True)
        loss, logits = self._loss(table, shape, idx, dense, label)
        g_tab, *g_dense = torch.autograd.grad(loss, [table, *self.params])
        with torch.no_grad():
            # rowwise AdaGrad over the whole table (g_tab is the dense,
            # duplicate-summed gradient; untouched rows add 0)
            self.accum = self.accum + torch.mean(g_tab * g_tab, dim=1)
            scale = self.table_lr * torch.rsqrt(self.accum + self.eps)
            self.table = self.table - scale[:, None] * g_tab
            self.opt_state = optim.dense_adam_update(self.params, g_dense, self.opt_state,
                                                     self.run_cfg.dense_learning_rate)
        self.step += 1
        self.auc.update(logits.detach(), label)
        return {"loss": float(loss.detach())}

    @torch.no_grad()
    def eval_step(self, batch: dict) -> dict:
        loss, logits = self._loss(self.table, *self._inputs(batch))
        return {"loss": float(loss), "logits": logits}
