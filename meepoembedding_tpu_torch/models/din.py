"""DIN, the Deep Interest Network (port of `meepoembedding_tpu/models/din.py`).

Sparse feature 0 is the target (the candidate ad); every other feature is
a behaviour bag that the target attends: the weight of bag element e is an
MLP over [e, t, e*t, e-t] (the activation unit), masked-softmaxed over the
bag. The model pools inside (`pools_inside`), so the trainer hands it the
raw [B, S, L, D] rows and the validity mask. All-padding bags pool to
zeros. One-hot [B, S] batches are bags of one.
"""

from __future__ import annotations

import torch
from torch import nn

from meepoembedding_tpu_torch.config import ModelConfig
from meepoembedding_tpu_torch.models.common import DTYPES, MLP


def bags(emb: torch.Tensor, bag_valid):
    """[B, S, D] one-hot or [B, S, L, D] rows -> ([B, S, L, D] f32, [B, S, L]
    bool mask)."""
    if emb.dim() == 3:  # one-hot: bags of one
        emb = emb[:, :, None, :]
    if bag_valid is None:
        bag_valid = torch.ones(emb.shape[:3], dtype=torch.bool, device=emb.device)
    return emb.to(torch.float32), bag_valid


def masked_mean(x: torch.Tensor, valid: torch.Tensor, dim: int) -> torch.Tensor:
    """Mean of x [..., L, D] over its valid lanes along `dim` (0 where none)."""
    v = valid.to(torch.float32)
    cnt = torch.clamp(v.sum(dim, keepdim=True), min=1.0)
    return (x * v[..., None]).sum(dim) / cnt


class DIN(nn.Module):
    pools_inside = True

    def __init__(self, cfg: ModelConfig, generator: torch.Generator = None):
        super().__init__()
        if cfg.num_sparse_features < 2:
            raise ValueError("DIN needs a target feature (column 0) plus >= 1 behaviour bag")
        self.cfg = cfg
        self.num_behaviors = cfg.num_sparse_features - 1
        dt, d = DTYPES[cfg.dtype], cfg.embedding_dim
        # activation unit: [e, t, e*t, e-t] -> a scalar weight
        self.att = MLP(4 * d, tuple(cfg.attention_mlp) + (1,), dtype=dt, generator=generator)
        self.top = MLP(cfg.num_dense_features + d + self.num_behaviors * d, cfg.top_mlp,
                       dtype=dt, generator=generator)

    def jax_tree(self) -> dict:
        return {"att": self.att.jax_tree(), "top": self.top.jax_tree()}

    def forward(self, dense: torch.Tensor, emb: torch.Tensor, bag_valid=None) -> torch.Tensor:
        """dense [B, ND]; emb [B, S, L, D] raw bag rows (or [B, S, D] one-hot);
        bag_valid [B, S, L] bool or None -> logits [B] f32."""
        emb, bag_valid = bags(emb, bag_valid)
        b = emb.shape[0]
        # target vector: masked mean of feature 0's bag (usually L = 1)
        target = masked_mean(emb[:, 0], bag_valid[:, 0], 1)  # [B, D]
        behav, bv = emb[:, 1:], bag_valid[:, 1:]  # [B, S-1, L, D], [B, S-1, L]
        t4 = target[:, None, None, :].expand_as(behav)
        feats = torch.cat([behav, t4, behav * t4, behav - t4], dim=-1)  # [B, S-1, L, 4D]
        a = self.att(feats)[..., 0].to(torch.float32)
        a = torch.softmax(torch.where(bv, a, torch.full_like(a, -1e9)), dim=-1)
        # all-padding bags: a softmax over all -1e9 is uniform; zero it
        a = a * bv.any(dim=-1, keepdim=True).to(torch.float32)
        pooled = torch.einsum("bsl,bsld->bsd", a, behav)  # [B, S-1, D]
        z = torch.cat([dense.to(torch.float32), target, pooled.reshape(b, -1)], dim=1)
        return self.top(z).reshape(-1).to(torch.float32)
