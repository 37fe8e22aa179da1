"""CTR-MLP, the wide concat-MLP CTR model (port of
`meepoembedding_tpu/models/ctr_mlp.py`): the dense features and the
flattened pooled embeddings, concatenated, through one ReLU MLP to a logit.
"""

from __future__ import annotations

import torch
from torch import nn

from meepoembedding_tpu_torch.config import ModelConfig
from meepoembedding_tpu_torch.models.common import DTYPES, MLP, check_widths


class CtrMlp(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator = None):
        super().__init__()
        self.cfg = cfg
        in_dim = cfg.num_dense_features + cfg.num_sparse_features * cfg.embedding_dim
        self.mlp = MLP(in_dim, cfg.top_mlp, dtype=DTYPES[cfg.dtype], generator=generator)

    def jax_tree(self) -> dict:
        return {"mlp": self.mlp.jax_tree()}

    def forward(self, dense: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        """dense [B, ND]; emb [B, NS, D] -> logits [B] f32."""
        check_widths(self.cfg, dense, emb)
        dt = DTYPES[self.cfg.dtype]
        z = torch.cat([dense.to(dt), emb.reshape(dense.shape[0], -1).to(dt)], dim=1)
        return self.mlp(z).reshape(-1).to(torch.float32)
