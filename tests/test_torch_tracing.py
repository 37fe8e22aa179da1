"""The port's named spans (`meepoembedding_tpu_torch.tracing`), on the CPU:
off, a step and a request enter no `record_function`; under the profiler
the exported Chrome trace holds the spans, nested as the code nests them,
one `meepo.table.plan_round` a planning round and one
`meepo.table.plan_sync` a check of the planning loop."""

from __future__ import annotations

import collections
import json

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from meepoembedding_tpu_torch import tracing
from meepoembedding_tpu_torch.config import ModelConfig, RunConfig, TableConfig
from meepoembedding_tpu_torch.serving import ScoringService
from meepoembedding_tpu_torch.train import Trainer

B, S, ND, DIM = 64, 3, 4, 8


def _batch(first_id: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    ids = np.arange(first_id, first_id + B * S, dtype=np.int64).reshape(B, S)
    return {"dense": rng.standard_normal((B, ND)).astype(np.float32), "ids": ids,
            "label": (rng.random(B) < 0.5).astype(np.float32)}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A trainer on a 32-bucket table that has seen one batch, and a scoring
    service on its checkpoint."""
    torch.set_num_threads(2)
    mc = ModelConfig(num_dense_features=ND, num_sparse_features=S, embedding_dim=DIM,
                     bottom_mlp=(16, DIM), top_mlp=(16, 1))
    tc = TableConfig(dim=DIM, capacity=1 << 12)
    tr = Trainer(RunConfig(batch_size=B), tc, mc, device="cpu")
    tr.train_step(_batch(1, 0))
    path = str(tmp_path_factory.mktemp("tracing") / "ckpt")
    tr.save_checkpoint(path)
    return tr, ScoringService(path, tc, mc, device="cpu")


def _traced(fn, tmp_path):
    """The main thread's `meepo.` ranges (name, start, end) of the Chrome
    trace of fn run under the CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e["name"].startswith("meepo.")]
    main = collections.Counter(e["tid"] for e in spans).most_common(1)[0][0]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in spans if e["tid"] == main]


def _holds(spans, outer: str, inner: str) -> bool:
    return any(a <= c and d <= b for n, a, b in spans if n == outer
               for m, c, d in spans if m == inner)


def _count(spans, name: str) -> int:
    return sum(n == name for n, _, _ in spans)


def test_the_profiler_flag_flips():
    assert not autograd_profiler._is_profiler_enabled
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled
        assert isinstance(tracing.span("meepo.x"), torch.profiler.record_function)
    assert not autograd_profiler._is_profiler_enabled
    assert tracing.span("meepo.x") is tracing.span("meepo.y")


def test_no_record_function_without_a_profiler(setup, monkeypatch):
    tr, svc = setup
    calls = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name, *a: calls.append(name))
    tr.train_step(_batch(1, 1))
    svc.score(_batch(1, 2)["dense"][:8], _batch(1, 2)["ids"][:8])
    assert calls == []


def test_a_step_nests_the_table_spans(setup, tmp_path):
    tr, _ = setup
    spans = _traced(lambda: tr.train_step(_batch(10_000, 3)), tmp_path)
    assert _count(spans, "meepo.train.step") == 1
    assert _holds(spans, "meepo.train.step", "meepo.table.lookup")
    assert _holds(spans, "meepo.table.lookup", "meepo.table.probe")
    assert _holds(spans, "meepo.table.lookup", "meepo.table.plan")
    assert _holds(spans, "meepo.table.plan", "meepo.table.plan_round")
    assert _holds(spans, "meepo.table.plan", "meepo.table.plan_sync")
    assert _holds(spans, "meepo.table.fresh", "meepo.table.counters_sync")
    for part in ("train.inputs", "table.dedup", "table.admit", "table.gather",
                 "tower.forward", "tower.backward", "table.update", "tower.update",
                 "train.metrics", "train.loss_sync"):
        assert _holds(spans, "meepo.train.step", f"meepo.{part}"), part


def test_planning_rounds_and_syncs(setup, tmp_path):
    """New ids that all fit their first bucket take one round and two checks
    (before the round, and the one that ends the loop); known ids none and
    one."""
    tr, _ = setup
    new = _traced(lambda: tr.train_step(_batch(20_000, 4)), tmp_path)
    assert (_count(new, "meepo.table.plan_round"), _count(new, "meepo.table.plan_sync")) == (1, 2)
    known = _traced(lambda: tr.train_step(_batch(20_000, 5)), tmp_path)
    assert (_count(known, "meepo.table.plan_round"),
            _count(known, "meepo.table.plan_sync")) == (0, 1)
    assert sum(n.endswith("_sync") for n, _, _ in known) == 3


def test_a_request_nests_the_serve_spans(setup, tmp_path):
    _, svc = setup
    b = _batch(1, 6)
    spans = _traced(lambda: svc.score(b["dense"][:16], b["ids"][:16]), tmp_path)
    assert _count(spans, "meepo.serve.request") == 1
    for inner in ("meepo.serve.queue", "meepo.serve.inputs", "meepo.table.dedup",
                  "meepo.table.probe", "meepo.table.gather", "meepo.tower.forward",
                  "meepo.serve.readback_sync"):
        assert _holds(spans, "meepo.serve.request", inner), inner
