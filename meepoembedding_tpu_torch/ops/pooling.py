"""Pooled multi-hot embedding lookup (port of `meepoembedding_tpu/ops/pooling.py`).

A bag is a fixed `[B, S, L]` id tensor padded with the invalid id. Padding
ids resolve to zero rows in the lookup, so pooling is a plain sum over the
bag, divided by the combiner's count of real ids.
"""

from __future__ import annotations

import torch

COMBINERS = ("sum", "mean", "sqrtn")


def bag_counts(bag_valid: torch.Tensor) -> torch.Tensor:
    """[B, S, L] validity -> [B, S] f32 count of real ids per bag."""
    return bag_valid.to(torch.float32).sum(dim=-1)


def pool_bags(emb: torch.Tensor, bag_valid: torch.Tensor, combiner: str) -> torch.Tensor:
    """[B, S, L, dim] rows (zero under padding) -> [B, S, dim]. Empty bags
    pool to zeros under every combiner (the count clamps to 1)."""
    if combiner not in COMBINERS:
        raise ValueError(f"combiner must be one of {COMBINERS}, got {combiner!r}")
    s = emb.sum(dim=2)
    if combiner == "sum":
        return s
    cnt = bag_counts(bag_valid).clamp(min=1.0)
    if combiner == "mean":
        return s / cnt[..., None]
    return s / torch.sqrt(cnt)[..., None]


def pool_or_reshape(emb_flat: torch.Tensor, ids_shape, bag_valid, dim: int,
                    combiner: str) -> torch.Tensor:
    """[n, dim] gathered rows (batch order) -> [B, S, dim] model inputs for
    one-hot [B, S] and multi-hot [B, S, L] id batches."""
    emb = emb_flat.reshape(tuple(ids_shape) + (dim,))
    if len(ids_shape) == 2:
        return emb
    return pool_bags(emb, bag_valid, combiner)
