"""Host ranges around the port's module-level calls, for the traced run
only: each call below runs inside `torch.profiler.record_function("bench.<layer>")`
while `annotate()` is active, so that `trace.timeline` can tie the device
operations it launches to that layer. The untraced runs call the port
unwrapped.

Layers (as PERF.md lists them):
  table   ops/dedup.py (the dedup, the gather to batch order and its
          segment-sum backward), table/table_ops.py `lookup_train`, the id
          split of table/hashing.py, and the sparse half of ops/optim.py
  tower   models/ (the forward and loss, through train.py's `model_inputs`
          and `model_loss`), their backward nodes in the autograd engine, and
          the dense Adam of ops/optim.py
  serve   serving.py `ScoringService.score`, annotated by the serving cell
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import torch

RULES = (
    ("bench.table", "table"),
    ("bench.tower", "tower"),
    ("bench.serve", "serve"),
    ("autograd::engine::evaluate_function", "tower"),
)


def layer_of(name: str) -> Optional[str]:
    for prefix, layer in RULES:
        if name.startswith(prefix):
            return layer
    return None


def _wrap(fn, name: str):
    @functools.wraps(fn)
    def inner(*a, **k):
        with torch.profiler.record_function(name):
            return fn(*a, **k)
    return inner


def _targets():
    from meepoembedding_tpu_torch import train
    from meepoembedding_tpu_torch.ops import dedup, optim
    from meepoembedding_tpu_torch.table import hashing, table_ops

    return [
        (hashing, "split_ids_t", "bench.table"),
        (dedup, "unique_pairs", "bench.table"),
        (table_ops, "lookup_train", "bench.table"),
        (optim, "apply_sparse_grads_ctx", "bench.table"),
        (train, "model_inputs", "bench.tower"),
        (train, "model_loss", "bench.tower"),
        (optim, "dense_adam_update", "bench.tower"),
        (optim, "clip_by_global_norm", "bench.tower"),
    ], dedup.GatherRows


@contextlib.contextmanager
def annotate():
    """Wrap the training step's layers for the block; restore them after."""
    targets, gather = _targets()
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]
    fwd, bwd = gather.forward, gather.backward
    try:
        for mod, attr, name in targets:
            setattr(mod, attr, _wrap(getattr(mod, attr), name))
        gather.forward = staticmethod(_wrap(fwd, "bench.table"))
        gather.backward = staticmethod(_wrap(bwd, "bench.table"))
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
        gather.forward, gather.backward = staticmethod(fwd), staticmethod(bwd)
