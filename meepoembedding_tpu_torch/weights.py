"""Load the reference's dense parameters into the port's modules.

The JAX package keeps DLRM params as a pytree {"bottom": [(W, b), ...],
"top": [(W, b), ...]} with W stored [in, out]; its checkpoints store the
tree's leaves in `jax.tree_util` flatten order (dict keys sorted, so bottom
w0, b0, w1, b1, ..., then top). `from_jax_params` takes either form as
numpy arrays and copies them into the module, transposing W into
`nn.Linear`'s [out, in].
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch
from torch import nn


def _flatten(params) -> list:
    if isinstance(params, dict):
        return [leaf for k in sorted(params) for leaf in _flatten(params[k])]
    if isinstance(params, (list, tuple)):
        return [leaf for p in params for leaf in _flatten(p)]
    return [np.asarray(params)]


def _towers(model: nn.Module):
    """The model's MLP towers in flatten order of the reference's pytree."""
    names = sorted(n for n, _ in model.named_children() if n in ("bottom", "top"))
    if not names:
        raise TypeError(f"{type(model).__name__} has no bottom/top MLP towers")
    return [getattr(model, n) for n in names]


def from_jax_params(model: nn.Module, params: Union[dict, Sequence[np.ndarray]]) -> nn.Module:
    """Copy JAX params (a nested pytree or its flat leaf list) into `model`,
    in place; returns the model. Raises on a count or shape mismatch: a model
    geometry that differs from the trained one would score garbage."""
    leaves = _flatten(params)
    linears = [lin for tower in _towers(model) for lin in tower.layers]
    if len(leaves) != 2 * len(linears):
        raise ValueError(
            f"{len(leaves)} parameter leaves for a model with {len(linears)} "
            f"linear layers ({2 * len(linears)} leaves)"
        )
    with torch.no_grad():
        for j, lin in enumerate(linears):
            w, b = leaves[2 * j], leaves[2 * j + 1]
            want_w = (lin.in_features, lin.out_features)
            if tuple(w.shape) != want_w or tuple(b.shape) != (lin.out_features,):
                raise ValueError(
                    f"leaf {2 * j}: checkpoint shapes {w.shape}, {b.shape} != model "
                    f"shapes {want_w}, ({lin.out_features},); the model geometry at "
                    "restore must match the one trained"
                )
            lin.weight.copy_(torch.from_numpy(np.array(w.T)).to(lin.weight.dtype))
            lin.bias.copy_(torch.from_numpy(np.array(b)).to(lin.bias.dtype))
    return model
