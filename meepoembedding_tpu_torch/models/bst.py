"""BST, the Behavior Sequence Transformer (port of
`meepoembedding_tpu/models/bst.py`; Chen et al., 2019).

Sparse feature 0 is the target item, feature 1 the ordered behaviour
sequence (its bag index is the position), features 2.. context features
pooled by masked mean. The tokens [target] + behaviours, plus a learned
position table (`max_seq_len` rows), go through `transformer_blocks`
post-LN encoder blocks (multi-head self-attention over the valid tokens, a
ReLU FFN); the masked mean of the encoded sequence, the target, the dense
features and the pooled context feed the top MLP.

The attention is written out as the reference writes it: projections
`x @ W` in f32, an additive -1e9 mask on padded keys and a softmax in f32.
`nn.MultiheadAttention` packs and biases its projections, so the
reference's wq/wk/wv/wo cannot map onto it; `scaled_dot_product_attention`
treats fully masked rows otherwise. LayerNorm uses the reference's eps
(1e-6; `nn.LayerNorm` defaults to 1e-5). The encoder blocks run inside the
span `meepo.tower.attention`.

Given `lengths`, the trainer and the scoring service hand the model its
bags by position without padding ever reaching the table
(`pooling.takes_positional`): the rows at their places of a zero
[B, S, L, D] input, and the validity from the lengths.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from meepoembedding_tpu_torch.config import ModelConfig
from meepoembedding_tpu_torch.models.common import DTYPES, MLP, normal_
from meepoembedding_tpu_torch.models.din import bags, masked_mean
from meepoembedding_tpu_torch.tracing import span


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = torch.square(xf - mu).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


class _Block(nn.Module):
    """One post-LN encoder block; weights in the reference's layout."""

    def __init__(self, d: int, dt, generator):
        super().__init__()
        s = math.sqrt(1.0 / d)
        self.wq, self.wk, self.wv, self.wo = (normal_((d, d), s, dt, generator)
                                              for _ in range(4))
        self.ffn = MLP(d, (4 * d, d), dtype=dt, generator=generator)
        self.ln1_scale = nn.Parameter(torch.ones(d))
        self.ln1_bias = nn.Parameter(torch.zeros(d))
        self.ln2_scale = nn.Parameter(torch.ones(d))
        self.ln2_bias = nn.Parameter(torch.zeros(d))

    def jax_tree(self) -> dict:
        return {"ffn": self.ffn.jax_tree(), "ln1": (self.ln1_scale, self.ln1_bias),
                "ln2": (self.ln2_scale, self.ln2_bias), "wk": self.wk, "wo": self.wo,
                "wq": self.wq, "wv": self.wv}

    def forward(self, x: torch.Tensor, neg: torch.Tensor, heads: int) -> torch.Tensor:
        """x [B, T, D], neg [B, T] additive key mask -> [B, T, D]."""
        b, t, d = x.shape
        dh = d // heads

        def proj(w):  # [B, T, D] -> [B, H, T, dh], f32
            return (x.float() @ w.float()).reshape(b, t, heads, dh).transpose(1, 2)

        q, k, v = proj(self.wq), proj(self.wk), proj(self.wv)
        logits = (q @ k.transpose(-1, -2)) / torch.sqrt(torch.tensor(float(dh)))
        att = torch.softmax(logits + neg[:, None, None, :], dim=-1)
        ctx = (att @ v).transpose(1, 2).reshape(b, t, d).to(x.dtype)
        ctx = (ctx.float() @ self.wo.float()).to(x.dtype)
        x = _layer_norm(x + ctx, self.ln1_scale, self.ln1_bias)
        return _layer_norm(x + self.ffn(x), self.ln2_scale, self.ln2_bias)


class BST(nn.Module):
    pools_inside = True

    def __init__(self, cfg: ModelConfig, generator: torch.Generator = None):
        super().__init__()
        if cfg.num_sparse_features < 2:
            raise ValueError("BST needs a target feature (column 0) plus a behaviour "
                             "sequence (column 1)")
        d, h = cfg.embedding_dim, cfg.attention_heads
        if d % h:
            raise ValueError(f"embedding_dim {d} must be a multiple of attention_heads {h}")
        self.cfg = cfg
        self.num_context = cfg.num_sparse_features - 2
        dt = DTYPES[cfg.dtype]
        self.blocks = nn.ModuleList(_Block(d, dt, generator)
                                    for _ in range(cfg.transformer_blocks))
        self.pos = normal_((cfg.max_seq_len, d), 0.02, dt, generator)
        top_in = cfg.num_dense_features + 2 * d + self.num_context * d
        self.top = MLP(top_in, cfg.top_mlp, dtype=dt, generator=generator)

    def jax_tree(self) -> dict:
        return {"blocks": [blk.jax_tree() for blk in self.blocks], "pos": self.pos,
                "top": self.top.jax_tree()}

    def forward(self, dense: torch.Tensor, emb: torch.Tensor, bag_valid=None) -> torch.Tensor:
        """dense [B, ND]; emb [B, S, L, D] raw bag rows (or [B, S, D] one-hot);
        bag_valid [B, S, L] bool or None -> logits [B] f32."""
        cfg = self.cfg
        emb, bag_valid = bags(emb, bag_valid)
        b, _, L, _ = emb.shape
        if L + 1 > cfg.max_seq_len:
            raise ValueError(f"bag_len {L} + target exceeds model.max_seq_len "
                             f"{cfg.max_seq_len}")
        # the target: masked mean of feature 0's bag (usually L = 1)
        target = masked_mean(emb[:, 0], bag_valid[:, 0], 1)  # [B, D]
        tokens = torch.cat([target[:, None, :], emb[:, 1]], dim=1)  # [B, T, D]
        tok_valid = torch.cat([bag_valid[:, 0].any(1, keepdim=True), bag_valid[:, 1]], dim=1)
        tokens = (tokens + self.pos[:L + 1].float()).to(DTYPES[cfg.dtype])
        neg = torch.where(tok_valid, 0.0, -1e9).to(torch.float32)  # padded keys
        x = tokens
        with span("meepo.tower.attention"):
            for blk in self.blocks:
                x = blk(x, neg, cfg.attention_heads)
        seq = masked_mean(x.to(torch.float32), tok_valid, 1)  # [B, D]
        parts = [dense.to(torch.float32), target, seq]
        if self.num_context:
            parts.append(masked_mean(emb[:, 2:], bag_valid[:, 2:], 2).reshape(b, -1))
        return self.top(torch.cat(parts, dim=1)).reshape(-1).to(torch.float32)
