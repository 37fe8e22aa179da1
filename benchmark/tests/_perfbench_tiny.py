"""Tiny versions of the benchmark's cells for CPU tests: the published
widths, with the vocabulary, the table, the batch and the request sizes cut
so that a cell's set-up and steps run in seconds on the CPU."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from harness import spec  # noqa: E402

torch.set_num_threads(2)


def tiny_cell(workload: str):
    """The cell `workload` of the repository's BENCHMARK.json, cut down."""
    cell = spec.load_cell(workload, ROOT)
    cell = copy.deepcopy(cell)
    cards = [max(1, min(c, 400 + 37 * j)) for j, c in enumerate(cell.config["cardinalities"])]
    cell.config["cardinalities"] = cards
    cell.config["table"]["capacity"] = 1 << 14
    if cell.loop == "closed":
        cell.mix["batch"] = 64
        cell.mix["pool_batches"] = 4
    else:
        cell.mix.update(candidates_min=8, candidates_max=32, pool_candidates=512)
    return cell
