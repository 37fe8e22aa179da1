"""Named host spans inside the training step, the table path and the
scoring request, on the profiler's clock.

`span(name)` is a `torch.profiler.record_function` range while a torch
profiler runs, and a shared no-op context otherwise: the check is one read
of the profiler's own flag, so a span costs a flag read when no profiler
runs and needs no switch. Any `torch.profiler` session (the benchmark's
traced run, `cli.py`'s `run.profile_dir`, an operator's own) shows the
spans in its Chrome trace beside the device's kernels and copies, so each
idle gap on the device can be put down to the span the host was in.

Names are `meepo.<layer>.<part>`, `<layer>` one of `train`, `table`,
`tower`, `serve`; a name ending in `_sync` marks a place where the host
waits for device work queued before it. The batch's and the request's
copies from pageable host memory synchronise too, but on a stream that the
previous step's or request's read-back has drained: they wait for the copy
alone, and their spans (`meepo.train.inputs`, `meepo.serve.inputs`) do not
end in `_sync`.

  meepo.train.step          Trainer.train_step, whole
  meepo.train.inputs        the step's host-to-device copies of its batch
  meepo.train.ragged        ragged bags: the valid ids taken
                            (`pooling.ragged_batch`), their copy, and each
                            id's bag on the device
  meepo.train.metrics       last_logits and the streaming AUC's update
  meepo.train.loss_sync     the loss's read-back
  meepo.table.dedup         dedup.unique_pairs
  meepo.table.lookup        table_ops.lookup_train
  meepo.table.probe         table_ops.probe
  meepo.table.admit         table_ops.cms_admit
  meepo.table.plan          table_ops.plan_insert
  meepo.table.plan_round    one planning round (one gather of the key planes)
  meepo.table.plan_sync     the planning loop's check for pending keys
  meepo.table.fresh         lookup_train after planning: the rows' gather,
                            the init, the side-plane writes, the counters
  meepo.table.counters_sync the counters' index copied from the host, which
                            waits for the work queued before it
  meepo.table.gather        GatherRows.forward; the probe-only lookup's
                            row gathers
  meepo.table.segment_sum   GatherRows.backward (on a card, in the
                            autograd engine's thread)
  meepo.table.pool          GatherRows.forward of ragged bags: each bag's
                            sum of its unique rows, then the combiner
  meepo.table.pool_backward its backward, the pooled gradient to the
                            unique rows
  meepo.table.update        optim.apply_sparse_grads_ctx
  meepo.tower.forward       the tower's forward (and loss, in a step)
  meepo.tower.cross         DLRM-DCNv2's cross net, in the forward
  meepo.tower.backward      torch.autograd.grad in a step
  meepo.tower.update        clip, learning rate and the dense Adam
  meepo.serve.request       ScoringService.score, whole
  meepo.serve.queue         waiting for the service's lock
  meepo.serve.inputs        a request's host-to-device copies
  meepo.serve.ragged        a request's ragged bags: as meepo.train.ragged
  meepo.serve.graph         a one-hot request on a card: its padded copy in
                            and the replay of its bucket's CUDA graph (on
                            the bucket's first request, the capture too)
  meepo.serve.readback_sync the scores' copy to the host
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: `record_function(name)` while a torch profiler
    runs, else a shared no-op context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorator form of `span`: the whole call runs inside it."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*a, **k):
            with span(name):
                return fn(*a, **k)
        return inner
    return wrap
