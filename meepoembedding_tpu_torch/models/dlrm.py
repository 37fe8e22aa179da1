"""DLRM dense tower (port of `meepoembedding_tpu/models/dlrm.py`).

Bottom MLP over the dense features, pairwise dot-product interaction of
[bottom output, sparse embeddings], top MLP to a CTR logit. The interaction
is one batched f32 `bmm`; its upper triangle is read in the row-major order
of `np.triu_indices(f, k=1)`, the reference's order, so the top MLP's input
columns line up with weights trained by the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from meepoembedding_tpu_torch.config import ModelConfig
from meepoembedding_tpu_torch.models.common import DTYPES, MLP, check_widths


class DLRM(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator = None):
        super().__init__()
        if cfg.bottom_mlp[-1] != cfg.embedding_dim:
            raise ValueError("bottom MLP must end at embedding_dim for dot interaction")
        self.cfg = cfg
        f = cfg.num_sparse_features + 1  # + the bottom-MLP output as a feature
        iu, ju = np.triu_indices(f, k=1)
        self.register_buffer("_iu", torch.from_numpy(iu.astype(np.int64)), persistent=False)
        self.register_buffer("_ju", torch.from_numpy(ju.astype(np.int64)), persistent=False)
        dt = DTYPES[cfg.dtype]
        self.bottom = MLP(cfg.num_dense_features, cfg.bottom_mlp, final_activation=True,
                          dtype=dt, generator=generator)
        self.top = MLP(cfg.embedding_dim + len(iu), cfg.top_mlp, dtype=dt,
                       generator=generator)

    def jax_tree(self) -> dict:
        return {"bottom": self.bottom.jax_tree(), "top": self.top.jax_tree()}

    def forward(self, dense: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        """dense [B, ND] f32; emb [B, NS, D] -> logits [B] f32."""
        check_widths(self.cfg, dense, emb)
        x = self.bottom(dense)  # [B, D]
        feats = torch.cat([x[:, None, :], emb.to(x.dtype)], dim=1)  # [B, F, D]
        f32 = feats.to(torch.float32)
        inter = torch.bmm(f32, f32.transpose(1, 2))  # [B, F, F]
        flat = inter[:, self._iu, self._ju]  # [B, F*(F-1)/2]
        z = torch.cat([x, flat.to(x.dtype)], dim=1)
        return self.top(z).reshape(-1).to(torch.float32)
