"""On the card, at each cell's own size on three seeds: the program passes
the cell's limits and the control (the reference in TF32, one step below
the configuration's float32, in the program's place) fails at least one.
`benchmark/control.py` reads the same numbers over more seeds."""

from __future__ import annotations

import gc

import pytest
import torch

import _perfbench_tiny
from harness import check, serve_cell, spec, train_cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs in TF32, which only a card has")
    yield torch.device("cuda:0")
    gc.collect()
    torch.cuda.empty_cache()


def _cell(workload):
    return spec.load_cell(workload, _perfbench_tiny.ROOT)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["dlrm-kaggle.train", "dlrm-mlperf-tb.train"])
@pytest.mark.parametrize("seed", [21, 22, 23])
def test_train_control_fails(card, workload, seed):
    cell = _cell(workload)
    tc = train_cell.TrainCell(cell, seed, card)
    prog = tc.first_steps()
    batches = tc.batches
    tc.free()
    del tc
    gc.collect()
    torch.cuda.empty_cache()
    ref32 = train_cell.reference_readings(cell.config, seed, batches, card)
    ctrl = train_cell.reference_readings(cell.config, seed, batches, card, kind="tf32")
    nc = cell.not_compared
    assert check.verdict(train_cell.compare(prog, ref32), cell.limits, nc)
    assert not check.verdict(train_cell.compare({**ctrl, "dropped": 0}, ref32), cell.limits, nc)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["dlrm-kaggle.serve", "dlrm-mlperf-tb.serve"])
@pytest.mark.parametrize("seed", [21, 22, 23])
def test_serve_control_fails(card, workload, seed):
    cell = _cell(workload)
    sc = serve_cell.ServeCell(cell, seed, card, 2.0)
    w = sc.window(2.0)
    prog, inputs, dropped = sc.answers()
    sc.free()
    del sc
    gc.collect()
    torch.cuda.empty_cache()
    ref32 = serve_cell.reference_scores(cell.config, seed, inputs, card)
    ctrl = serve_cell.reference_scores(cell.config, seed, inputs, card, kind="tf32")
    nc = cell.not_compared
    assert check.verdict(serve_cell.compare(prog, ref32, w["failed"], dropped), cell.limits, nc)
    assert not check.verdict(serve_cell.compare(ctrl, ref32, 0, 0), cell.limits, nc)
