"""The yardstick: the work a step or a request needs, from the
configuration's widths and the step's inputs alone, and the peaks of the
chip. A later change to a kernel is measured against the same work."""

from __future__ import annotations

from typing import Optional

from harness.weights import layer_shapes

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit: float32 outside
# the tensor cores, and HBM3 bandwidth
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"float32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peak(kind: str, what: str) -> Optional[float]:
    return PEAKS.get(kind, {}).get(what)


def macs_per_example(model: dict) -> int:
    """Multiply-adds of one example's forward pass: every linear layer, and
    the dot interaction as the [F, D] x [D, F] product it is computed as
    (F = sparse + 1)."""
    f, d = model["num_sparse_features"] + 1, model["embedding_dim"]
    return sum(i * o for i, o in layer_shapes(model)) + f * f * d


def train_flops_per_example(model: dict) -> int:
    """Forward and backward: three forward passes' worth, two FLOPs a MAC."""
    return 6 * macs_per_example(model)


def table_step_bytes(n_ids: int, n_unique: int, n_fresh: int, dim: int,
                     value_bytes: int = 4) -> int:
    """The least bytes a training step's table work moves, each once:

      per unique id    its 8-byte key read, its value row read and written,
                       its 4-byte accumulator read and written
      per first
        sighting       its key written and its freq and last words (16 bytes)
      per batch id     its 8-byte id read, its row written out in batch
                       order and its gradient row read back in
    """
    row = dim * value_bytes
    per_unique = 8 + 2 * row + 2 * 4
    per_id = 8 + 2 * row
    return n_unique * per_unique + n_fresh * 16 + n_ids * per_id
