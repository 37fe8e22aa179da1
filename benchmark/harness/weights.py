"""The DLRM tower's weights, made from the seed on the device in one call.

Leaves are in the JAX package's layout and order, which the port's
`weights.from_jax_params` takes: for each layer of the bottom MLP and then
of the top MLP, W [in, out] and b [out]. W ~ N(0, 2 / (in + out)), b ~ N(0,
1 / out), the published model's init (facebookresearch/dlrm,
`dlrm_s_pytorch.py` `create_mlp`). The program gets host copies through `from_jax_params`; the
reference makes the same leaves again from the same seed.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from harness import seeds


def layer_shapes(model: dict) -> List[Tuple[int, int]]:
    """(in, out) of every linear layer, bottom MLP first, as the widths of
    `model` give them; the top MLP's input is the bottom output beside the
    upper triangle of the dot interaction of F = sparse + 1 features."""
    shapes, d = [], model["num_dense_features"]
    for h in model["bottom_mlp"]:
        shapes.append((d, h))
        d = h
    f = model["num_sparse_features"] + 1
    d = model["embedding_dim"] + f * (f - 1) // 2
    for h in model["top_mlp"]:
        shapes.append((d, h))
        d = h
    return shapes


def tower_leaves(model: dict, seed: int, device) -> List[torch.Tensor]:
    shapes = layer_shapes(model)
    total = sum(i * o + o for i, o in shapes)
    g = seeds.torch_gen(seed, "tower", device)
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    leaves, at = [], 0
    for i, o in shapes:
        w = flat[at:at + i * o].view(i, o) * (2.0 / (i + o)) ** 0.5
        at += i * o
        b = flat[at:at + o] * (1.0 / o) ** 0.5
        at += o
        leaves += [w, b]
    return leaves
