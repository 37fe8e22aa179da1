"""Shared model pieces (port of `meepoembedding_tpu/models/common.py`).

Every model of the port is an `nn.Module` whose `forward` is the
reference's `apply`, and whose `jax_tree()` returns its parameters in the
nesting of the reference's param pytree (dicts, lists, tuples), so that
`weights.py` can map them to and from the reference's flat leaves. The
reference stores an MLP weight [in, out]; the port keeps `nn.Linear`'s
[out, in] and transposes there. Every other weight is kept in the
reference's layout (`x @ w`)."""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def normal_(shape, std: float, dtype, generator: torch.Generator) -> nn.Parameter:
    """A parameter drawn from Normal(0, std) with `generator`, as the
    reference's `jax.random.normal(key, shape, dtype) * std` (the same
    distribution, not the same numbers)."""
    return nn.Parameter((torch.randn(shape, generator=generator) * std).to(dtype))


def check_widths(cfg, dense: torch.Tensor, emb: torch.Tensor) -> None:
    """Raise unless the batch carries the configured feature counts: a
    model fed other widths would score garbage."""
    if emb.shape[1] != cfg.num_sparse_features:
        raise ValueError(f"emb carries {emb.shape[1]} sparse features, model configured "
                         f"for {cfg.num_sparse_features}")
    if dense.shape[1] != cfg.num_dense_features:
        raise ValueError(f"dense carries {dense.shape[1]} features, model configured "
                         f"for {cfg.num_dense_features}")


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

    def jax_tree(self) -> list:
        return [(lin.weight, lin.bias) for lin in self.layers]

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


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on logits, numerically stable (the reference's
    formula: mean(max(z, 0) - z * y + log1p(exp(-|z|))))."""
    z = logits.reshape(-1)
    y = labels.reshape(-1).to(torch.float32)
    return torch.mean(torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-z.abs())))


def model_loss(model, dense, emb, bag_valid, label, item_key=None, logq=None):
    """The trainers' objective: a retrieval model's own `loss_and_logits`
    (in-batch softmax, models/two_tower.py), else pointwise BCE over the
    model's logits. Returns (loss, per-example metric logits)."""
    fn = getattr(model, "loss_and_logits", None)
    if fn is not None:
        return fn(dense, emb, label, item_key, logq=logq)
    logits = model_apply(model, dense, emb, bag_valid)
    return bce_with_logits(logits, label), logits


def batch_item_key(model, hi, lo):
    """[B] item identity key for accidental-hit masking, or None for models
    without one (a function of the id planes alone)."""
    fn = getattr(model, "item_key", None)
    return None if fn is None else fn(hi, lo)
