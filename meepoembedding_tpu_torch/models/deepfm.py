"""DeepFM, a factorization machine beside a deep tower (port of
`meepoembedding_tpu/models/deepfm.py`; Guo et al., 2017). Summed into one
logit:

  - FM second order: 0.5 * sum_d[(sum_i e_id)^2 - sum_i e_id^2];
  - first order: a learned per-feature projection w1 [S, D], w1_i . e_i;
  - deep: a ReLU MLP (cfg.top_mlp) over [dense | flattened embeddings];
  - a dense linear term wd [ND] and a scalar bias b.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from meepoembedding_tpu_torch.config import ModelConfig
from meepoembedding_tpu_torch.models.common import DTYPES, MLP, check_widths, normal_


class DeepFM(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator = None):
        super().__init__()
        self.cfg = cfg
        dt = DTYPES[cfg.dtype]
        in_dim = cfg.num_dense_features + cfg.num_sparse_features * cfg.embedding_dim
        self.w1 = normal_((cfg.num_sparse_features, cfg.embedding_dim),
                          math.sqrt(1.0 / cfg.embedding_dim), dt, generator)
        self.deep = MLP(in_dim, cfg.top_mlp, dtype=dt, generator=generator)
        self.wd = normal_((cfg.num_dense_features,), 0.1, dt, generator)
        self.b = nn.Parameter(torch.zeros((), dtype=torch.float32))

    def jax_tree(self) -> dict:
        return {"b": self.b, "deep": self.deep.jax_tree(), "w1": self.w1, "wd": self.wd}

    def forward(self, dense: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        """dense [B, ND]; emb [B, NS, D] -> logits [B] f32."""
        check_widths(self.cfg, dense, emb)
        s = emb.sum(dim=1)  # [B, D]
        fm2 = 0.5 * (s * s - (emb * emb).sum(dim=1)).sum(dim=1)  # [B]
        first = (emb * self.w1[None, :, :]).sum(dim=(1, 2))  # [B]
        dt = self.wd.dtype
        x = torch.cat([dense.to(dt), emb.reshape(dense.shape[0], -1).to(dt)], dim=1)
        deep = self.deep(x).reshape(-1).to(torch.float32)
        lin_d = dense.to(dt).float() @ self.wd.float()
        return (fm2 + first + deep + lin_d + self.b).to(torch.float32)
