"""The yardstick: the work a step or a request needs, from the
configuration's widths and the step's inputs alone, and the peaks of the
chip. A later change to a kernel is measured against the same work."""

from __future__ import annotations

from typing import Optional

from harness import spec

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit: float32 outside
# the tensor cores, and HBM3 bandwidth
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"float32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peak(kind: str, what: str) -> Optional[float]:
    return PEAKS.get(kind, {}).get(what)


def train_flops_per_example(cfg: dict) -> int:
    """Forward and backward: three forward passes' worth, two FLOPs a MAC,
    of the multiply-adds that the configuration's reference module counts
    in one example's forward pass (`macs_per_example(model)`)."""
    return 6 * spec.reference(cfg).macs_per_example(cfg["model"])


def table_step_bytes(n_ids: int, n_unique: int, n_fresh: int, dim: int,
                     value_bytes: int = 4, n_bags: Optional[int] = None) -> int:
    """The least bytes a training step's table work moves, each once, over
    the batch's valid ids (padding of a bag is no id):

      per unique id    its 8-byte key read, its value row read and written,
                       its 4-byte accumulator read and written
      per first
        sighting       its key written and its freq and last words (16 bytes)
      per batch id     its 8-byte id read
      per bag          its pooled row written out and its gradient row read
                       back in; a one-hot feature's bag is its one id
                       (`n_bags` defaults to `n_ids`)
    """
    row = dim * value_bytes
    per_unique = 8 + 2 * row + 2 * 4
    bags = n_ids if n_bags is None else n_bags
    return n_unique * per_unique + n_fresh * 16 + n_ids * 8 + bags * 2 * row
