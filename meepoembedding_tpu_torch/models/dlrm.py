"""DLRM dense tower (port of `meepoembedding_tpu/models/dlrm.py`).

Bottom MLP over the dense features, pairwise dot-product interaction of
[bottom output, sparse embeddings], top MLP to a CTR logit. The interaction
is one batched f32 `bmm`; its upper triangle is read in the row-major order
of `np.triu_indices(f, k=1)`, the reference's order, so the top MLP's input
columns line up with weights trained by the JAX package.

Not in the reference: `ModelConfig.interaction="dcn"` swaps the dot
products for MLPerf DLRM-DCNv2's low-rank cross net (TorchRec
`LowRankCrossNet`) over x0 = [bottom output | the S pooled embeddings]
flattened, N wide:

    x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l,   l < num_cross_layers

with V_l [r, N], W_l [N, r] (r = `dcn_low_rank_dim`) and no activation
between them; the top MLP takes the cross net's output alone. V_l and W_l
are `nn.Linear` weights (W_l with the bias b_l), as TorchRec keeps them, so
their leaves are in the reference layout (`x @ V` with V [N, r], `@ W` with
W [r, N]), transposed as every MLP weight is; the leaves are bottom, then
(V, W, b) a layer, then top. The products run in float32 as torch's
defaults leave them (TF32 off).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from meepoembedding_tpu_torch.config import ModelConfig
from meepoembedding_tpu_torch.models.common import DTYPES, MLP, check_widths
from meepoembedding_tpu_torch.tracing import span

INTERACTIONS = ("dot", "dcn")


def cross_layer(x0: torch.Tensor, x: torch.Tensor, v: nn.Linear, w: nn.Linear) -> torch.Tensor:
    """One low-rank cross layer: x0 * (W (V x) + b) + x."""
    return torch.addcmul(x, x0, w(v(x)))


class DLRM(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator = None):
        super().__init__()
        if cfg.interaction not in INTERACTIONS:
            raise ValueError(f"interaction must be one of {INTERACTIONS}, got "
                             f"{cfg.interaction!r}")
        self.cfg = cfg
        dt = DTYPES[cfg.dtype]
        self.bottom = MLP(cfg.num_dense_features, cfg.bottom_mlp, final_activation=True,
                          dtype=dt, generator=generator)
        if cfg.interaction == "dcn":
            if cfg.dcn_low_rank_dim < 1:
                raise ValueError("interaction 'dcn' needs dcn_low_rank_dim >= 1")
            n = cfg.bottom_mlp[-1] + cfg.num_sparse_features * cfg.embedding_dim
            r = cfg.dcn_low_rank_dim
            std = math.sqrt(2.0 / (n + r))  # xavier-normal, as LowRankCrossNet
            self.cross_v = nn.ModuleList(
                [nn.Linear(n, r, bias=False, dtype=dt) for _ in range(cfg.num_cross_layers)])
            self.cross_w = nn.ModuleList(
                [nn.Linear(r, n, dtype=dt) for _ in range(cfg.num_cross_layers)])
            with torch.no_grad():
                for v, w in zip(self.cross_v, self.cross_w):
                    v.weight.normal_(0.0, std, generator=generator)
                    w.weight.normal_(0.0, std, generator=generator)
                    w.bias.zero_()
            self.top = MLP(n, cfg.top_mlp, dtype=dt, generator=generator)
            return
        if cfg.bottom_mlp[-1] != cfg.embedding_dim:
            raise ValueError("bottom MLP must end at embedding_dim for dot interaction")
        f = cfg.num_sparse_features + 1  # + the bottom-MLP output as a feature
        iu, ju = np.triu_indices(f, k=1)
        self.register_buffer("_iu", torch.from_numpy(iu.astype(np.int64)), persistent=False)
        self.register_buffer("_ju", torch.from_numpy(ju.astype(np.int64)), persistent=False)
        self.top = MLP(cfg.embedding_dim + len(iu), cfg.top_mlp, dtype=dt,
                       generator=generator)

    def jax_tree(self) -> dict:
        tree = {"bottom": self.bottom.jax_tree(), "top": self.top.jax_tree()}
        if self.cfg.interaction == "dcn":
            tree["cross"] = [(v.weight, w.weight, w.bias)
                             for v, w in zip(self.cross_v, self.cross_w)]
        return tree

    def forward(self, dense: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        """dense [B, ND] f32; emb [B, NS, D] -> logits [B] f32."""
        check_widths(self.cfg, dense, emb)
        x = self.bottom(dense)  # [B, D]
        if self.cfg.interaction == "dcn":
            x0 = torch.cat([x, emb.reshape(x.shape[0], -1).to(x.dtype)], dim=1)  # [B, N]
            z = x0
            with span("meepo.tower.cross"):
                for v, w in zip(self.cross_v, self.cross_w):
                    z = cross_layer(x0, z, v, w)
            return self.top(z).reshape(-1).to(torch.float32)
        feats = torch.cat([x[:, None, :], emb.to(x.dtype)], dim=1)  # [B, F, D]
        f32 = feats.to(torch.float32)
        inter = torch.bmm(f32, f32.transpose(1, 2))  # [B, F, F]
        flat = inter[:, self._iu, self._ju]  # [B, F*(F-1)/2]
        z = torch.cat([x, flat.to(x.dtype)], dim=1)
        return self.top(z).reshape(-1).to(torch.float32)
