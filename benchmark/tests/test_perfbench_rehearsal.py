"""A tiny-size CPU rehearsal of each cell: set-up, the first steps or the
window's requests, and the reference's verdict."""

from __future__ import annotations

import numpy as np
import pytest

from _perfbench_tiny import tiny_cell
from harness import check, serve_cell, train_cell


def run_train(cell, seed: int = 7):
    tc = train_cell.TrainCell(cell, seed, "cpu")
    prog = tc.first_steps()
    tc.warm(2)
    w = tc.window(0.2)
    batches = tc.batches
    tc.free()
    refr = train_cell.reference_readings(cell.config, seed, batches, "cpu")
    return train_cell.compare(prog, refr), w, tc


def run_serve(cell, seed: int = 7):
    sc = serve_cell.ServeCell(cell, seed, "cpu", 0.5)
    w = sc.window(0.5)
    prog, inputs, dropped = sc.answers()
    refr = serve_cell.reference_scores(cell.config, seed, inputs, "cpu")
    return serve_cell.compare(prog, refr, w["failed"], dropped), w


@pytest.mark.parametrize("workload", ["dlrm-kaggle.train", "dlrm-mlperf-tb.train"])
def test_train_cell_rehearsal(workload):
    cell = tiny_cell(workload)
    numbers, w, tc = run_train(cell)
    assert w["steps"] >= 1 and tc.failed == 0
    assert check.verdict(numbers, cell.limits, cell.not_compared), numbers


@pytest.mark.parametrize("workload", ["dlrm-kaggle.serve", "dlrm-mlperf-tb.serve"])
def test_serve_cell_rehearsal(workload):
    cell = tiny_cell(workload)
    numbers, w = run_serve(cell)
    assert w["answered"] == w["started"] > 0 and w["failed"] == 0
    # offered above what the service sustains: a backlog at the close
    assert w["backlog"] > 0
    assert np.isfinite(w["done_s"]).sum() == w["answered"]
    assert check.verdict(numbers, cell.limits, cell.not_compared), numbers
