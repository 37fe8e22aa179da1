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


# MLPerf DLRM-DCNv2's ids a feature (mlcommons/training recommendation_v2/
# torchrec_dlrm, --multi_hot_sizes): 214 an example, made by its
# --multi_hot_distribution_type uniform
DCNV2_SIZES = [3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100, 27, 10, 3, 1, 1]


def bag_cell(workload: str):
    """`tiny_cell(workload)` with DLRM-DCNv2's multi-hot bags, pooled by sum."""
    cell = tiny_cell(workload)
    cell.config["multi_hot_sizes"] = list(DCNV2_SIZES)
    cell.config["multi_hot_distribution"] = "uniform"
    cell.config["model"]["combiner"] = "sum"
    return cell
