"""Shared model pieces (port of `meepoembedding_tpu/models/common.py:12-62`)."""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn


class MLP(nn.Module):
    """ReLU MLP; the last layer is linear unless `final_activation`.

    Weights follow PyTorch's `nn.Linear` layout ([out, in]); the reference
    stores W as [in, out], and `weights.from_jax_params` transposes. A fresh
    module is He-initialised like the reference's `mlp_init` (normal with
    std sqrt(2 / fan_in), zero bias), from a torch generator: the same
    distribution, not the same numbers as `jax.random`."""

    def __init__(self, in_dim: int, sizes: Sequence[int], final_activation: bool = False,
                 dtype=torch.float32, generator: torch.Generator = None):
        super().__init__()
        self.final_activation = final_activation
        layers, d = [], in_dim
        for h in sizes:
            lin = nn.Linear(d, h, dtype=dtype)
            with torch.no_grad():
                lin.weight.normal_(0.0, math.sqrt(2.0 / d), generator=generator)
                lin.bias.zero_()
            layers.append(lin)
            d = h
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.layers)
        for i, lin in enumerate(self.layers):
            x = lin(x.to(lin.weight.dtype))
            if i < n - 1 or self.final_activation:
                x = torch.relu(x)
        return x


def model_inputs(model, emb_flat, ids_shape, bag_valid, dim: int, combiner: str):
    """[n, dim] gathered rows (batch order) -> the model's embedding input:
    raw [B, S, L, dim] bags for models that pool inside, else the
    combiner-pooled [B, S, dim]."""
    from meepoembedding_tpu_torch.ops import pooling

    if getattr(model, "pools_inside", False) and len(ids_shape) == 3:
        return emb_flat.reshape(tuple(ids_shape) + (dim,))
    return pooling.pool_or_reshape(emb_flat, ids_shape, bag_valid, dim, combiner)


def model_apply(model, dense, emb, bag_valid=None):
    """Forward dispatch: pools-inside models take the bag validity mask."""
    if getattr(model, "pools_inside", False):
        return model(dense, emb, bag_valid)
    return model(dense, emb)
