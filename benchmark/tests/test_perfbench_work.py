"""The yardstick's counts: model FLOPs and the table path's least bytes."""

from __future__ import annotations

import _perfbench_tiny  # noqa: F401  (paths)
from harness import spec, work
from reference import dlrm

REF = "benchmark/reference/dlrm.py"


def _model(name):
    return spec.load_cell(name, _perfbench_tiny.ROOT).config["model"]


def test_macs_per_example_at_published_widths():
    assert dlrm.macs_per_example(_model("dlrm-kaggle.train")) == 486_032
    assert dlrm.macs_per_example(_model("dlrm-mlperf-tb.train")) == 2_458_496


def test_macs_by_hand_on_a_small_tower():
    m = {"num_dense_features": 3, "num_sparse_features": 2, "embedding_dim": 4,
         "bottom_mlp": [5, 4], "top_mlp": [6, 1]}
    # bottom 3*5 + 5*4; F = 3: interaction 3*3*4; top input 4 + 3 = 7: 7*6 + 6*1
    assert dlrm.macs_per_example(m) == 15 + 20 + 36 + 42 + 6
    assert work.train_flops_per_example({"reference": REF, "model": m}) == 6 * 119


def test_table_step_bytes_by_hand():
    # 10 ids, 4 unique, 1 of them fresh, dim 2 (8-byte rows):
    # unique 4 * (8 key + 2 * 8 row + 2 * 4 accum) = 128; fresh 16;
    # ids 10 * (8 id + 8 row out + 8 grad in) = 240
    assert work.table_step_bytes(10, 4, 1, 2) == 128 + 16 + 240
    assert work.table_step_bytes(10, 4, 1, 2, n_bags=10) == 128 + 16 + 240
    assert work.table_step_bytes(0, 0, 0, 16) == 0
    # the same 10 ids in 3 bags: 10 * 8 id bytes, 3 * (8 out + 8 grad in)
    assert work.table_step_bytes(10, 4, 1, 2, n_bags=3) == 128 + 16 + 80 + 48


def test_peaks_are_known_for_the_h100_only():
    assert work.peak("NVIDIA H100 80GB HBM3", "float32_flops") == 67e12
    assert work.peak("NVIDIA H100 80GB HBM3", "hbm_bytes_per_s") == 3.35e12
    assert work.peak("cpu", "float32_flops") is None
