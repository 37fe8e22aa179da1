"""The tower's weights, made from the seed on the device in one call.

The configuration's reference module (`spec.reference`) lists the leaves
in `leaf_specs(model)`: (shape, std) of each, in the JAX package's layout
and order, which the port's `weights.from_jax_params` takes. One `randn`
call over all of them draws N(0, 1) values, which each leaf takes in that
order and scales by its std. The program gets host copies through
`from_jax_params`; the reference makes the same leaves again from the same
seed.
"""

from __future__ import annotations

import math
from typing import List

import torch

from harness import seeds, spec


def tower_leaves(cfg: dict, seed: int, device) -> List[torch.Tensor]:
    specs = spec.reference(cfg).leaf_specs(cfg["model"])
    total = sum(math.prod(shape) for shape, _ in specs)
    g = seeds.torch_gen(seed, "tower", device)
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    leaves, at = [], 0
    for shape, std in specs:
        n = math.prod(shape)
        leaves.append(flat[at:at + n].view(shape) * std)
        at += n
    return leaves
