"""Two-tower retrieval model (port of `meepoembedding_tpu/models/two_tower.py`).

A query tower embeds the dense context and the first `num_query_features`
sparse features, an item tower the rest, both L2-normalised into one space
with a learnable temperature; training is an in-batch sampled softmax
(one [B, E] x [E, B] matmul a step), with accidental hits (two rows of the
same item) masked and an optional log-q correction (`ops/itemfreq.py`).
`forward` scores (query, item) pairs, so scoring and eval treat the model as
a ranker.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from meepoembedding_tpu_torch.config import ModelConfig
from meepoembedding_tpu_torch.models.common import DTYPES, MLP
from meepoembedding_tpu_torch.table import hashing

# Salt decorrelating the accidental-hit item key from table and owner hashing.
_SALT_ITEM = 0x7FEB352D


def _l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(torch.square(x), -1, keepdim=True) + eps)


def _xor_reduce(h: torch.Tensor) -> torch.Tensor:
    """XOR of the columns of [B, K] non-negative int64 -> [B], by halving."""
    while h.shape[1] > 1:
        if h.shape[1] % 2:
            h = torch.cat([h, torch.zeros_like(h[:, :1])], dim=1)
        half = h.shape[1] // 2
        h = h[:, :half] ^ h[:, half:]
    return h[:, 0]


class TwoTower(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator = None):
        super().__init__()
        self.cfg = cfg
        self.qf = cfg.num_query_features
        self.itf = cfg.num_sparse_features - self.qf
        if not 0 < self.qf < cfg.num_sparse_features:
            raise ValueError(f"two_tower needs 1 <= num_query_features < num_sparse_features; "
                             f"got {self.qf} of {cfg.num_sparse_features}")
        self.embed_out = cfg.bottom_mlp[-1]
        dt, d = DTYPES[cfg.dtype], cfg.embedding_dim
        self.query = MLP(cfg.num_dense_features + self.qf * d, cfg.bottom_mlp, dtype=dt,
                         generator=generator)
        self.item = MLP(self.itf * d, cfg.bottom_mlp, dtype=dt, generator=generator)
        # learnable inverse temperature, f32 even for bf16 towers
        self.log_tau = nn.Parameter(torch.tensor(math.log(10.0), dtype=torch.float32))

    def jax_tree(self) -> dict:
        return {"item": self.item.jax_tree(), "log_tau": self.log_tau,
                "query": self.query.jax_tree()}

    # --- towers --------------------------------------------------------------
    def embed_query(self, dense: torch.Tensor, emb_q: torch.Tensor) -> torch.Tensor:
        """dense [B, ND] + query-side rows [B, QF, D] -> [B, E] unit vectors."""
        x = torch.cat([dense.to(torch.float32),
                       emb_q.reshape(dense.shape[0], -1).to(torch.float32)], dim=1)
        return _l2norm(self.query(x).to(torch.float32))

    def embed_item(self, emb_i: torch.Tensor) -> torch.Tensor:
        """item-side rows [B, IF, D] -> [B, E] unit vectors."""
        x = emb_i.reshape(emb_i.shape[0], -1).to(torch.float32)
        return _l2norm(self.item(x).to(torch.float32))

    def forward(self, dense: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        """[B] pairwise relevance logits tau * cos(query_b, item_b)."""
        q = self.embed_query(dense, emb[:, :self.qf])
        v = self.embed_item(emb[:, self.qf:])
        return torch.exp(self.log_tau) * torch.sum(q * v, dim=-1)

    # --- training objective ---------------------------------------------------
    def item_key(self, hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
        """[B] int32 identity key of each example's item-side ids ([B, S] or
        [B, S, L] int32 planes), for accidental-hit masking: a
        position-salted fmix32 of each id's hash, XOR-folded over the valid
        lanes; the reference's bits."""
        ehi, elo = hi[:, self.qf:], lo[:, self.qf:]
        h = hashing.hash_pair(ehi, elo, _SALT_ITEM)
        pos = torch.arange(1, h.shape[1] + 1, dtype=torch.int64, device=h.device)
        if h.dim() == 3:
            pos = pos[:, None]
        h = hashing.fmix32(hashing.mul32(h, pos))
        if h.dim() == 3:  # multi-hot bags: fold only the valid lanes
            h = torch.where(hashing.is_valid(ehi, elo), h, torch.zeros_like(h))
        h = _xor_reduce(h.reshape(h.shape[0], -1))
        return ((h ^ 0x80000000) - 0x80000000).to(torch.int32)

    def loss_and_logits(self, dense, emb, label, item_key=None, logq=None):
        """In-batch sampled-softmax retrieval loss. Rows with label > 0 are
        positives against the other rows' items; rows with label 0 add no
        loss but serve as negatives. `logq` [B] is subtracted from each
        item's column before the softmax (training only). Returns (loss,
        margin logits tau*s_ii - max_j!=i tau*s_ij)."""
        q = self.embed_query(dense, emb[:, :self.qf])  # [B, E]
        v = self.embed_item(emb[:, self.qf:])  # [B, E]
        scores = torch.exp(self.log_tau) * (q @ v.T)
        b = scores.shape[0]
        eye = torch.eye(b, dtype=torch.bool, device=scores.device)
        if item_key is not None:
            dup = (item_key[None, :] == item_key[:, None]) & ~eye
            scores = torch.where(dup, torch.full_like(scores, -1e9), scores)
        ce_scores = scores if logq is None else scores - logq[None, :]
        logp = torch.log_softmax(ce_scores, dim=1)
        w = label.reshape(-1).to(torch.float32)
        loss = -torch.sum(w * torch.diagonal(logp)) / torch.clamp(torch.sum(w), min=1.0)
        neg = torch.where(eye, torch.full_like(scores, -float("inf")), scores)
        margin = torch.diagonal(scores) - torch.max(neg, dim=1).values
        return loss, margin
