"""DCNv2, the Deep & Cross Network (port of `meepoembedding_tpu/models/dcn.py`).

Full-rank cross layers

    x_{l+1} = x_0 * (W_l x_l + b_l) + x_l

beside a deep ReLU tower over the same input x_0 = [dense | flattened
embeddings]; the two are concatenated into a linear head (Wang et al.,
2021). The cross weights keep the reference's layout ([I, I], `x @ W`).

This is not MLPerf DLRM-DCNv2's interaction, which is `dlrm` with
`interaction="dcn"` (models/dlrm.py): there the cross layers are low-rank
(W_l V_l, rank `dcn_low_rank_dim`), x_0 holds the bottom MLP's output in
place of the raw dense features, and the stack is sequential, the top MLP
over the cross net's output alone, with no deep tower beside it.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from meepoembedding_tpu_torch.config import ModelConfig
from meepoembedding_tpu_torch.models.common import DTYPES, MLP, check_widths, normal_


class DCNv2(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator = None):
        super().__init__()
        self.cfg = cfg
        dt = DTYPES[cfg.dtype]
        self.in_dim = i = cfg.num_dense_features + cfg.num_sparse_features * cfg.embedding_dim
        self.cross_w = nn.ParameterList(
            [normal_((i, i), math.sqrt(1.0 / i), dt, generator)
             for _ in range(cfg.num_cross_layers)])
        self.cross_b = nn.ParameterList(
            [nn.Parameter(torch.zeros(i, dtype=dt)) for _ in range(cfg.num_cross_layers)])
        sizes = tuple(cfg.top_mlp[:-1]) or (64,)
        self.deep = MLP(i, sizes, final_activation=True, dtype=dt, generator=generator)
        self.head = MLP(i + sizes[-1], (1,), dtype=dt, generator=generator)

    def jax_tree(self) -> dict:
        return {"cross": list(zip(self.cross_w, self.cross_b)), "deep": self.deep.jax_tree(),
                "head": self.head.jax_tree()}

    def forward(self, dense: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        """dense [B, ND]; emb [B, NS, D] -> logits [B] f32."""
        check_widths(self.cfg, dense, emb)
        dt = DTYPES[self.cfg.dtype]
        x0 = torch.cat([dense.to(dt), emb.reshape(dense.shape[0], -1).to(dt)], dim=1)
        x = x0
        for w, bias in zip(self.cross_w, self.cross_b):
            x = x0 * (x.float() @ w.float() + bias).to(dt) + x
        z = torch.cat([x, self.deep(x0)], dim=1)
        return self.head(z).reshape(-1).to(torch.float32)
