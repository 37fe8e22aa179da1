"""The trace reduction on a synthetic timeline: layer attribution through
the launching thread's host ranges, busy time, idle share and the idle
gaps named by the host's activity, and the metric readers over it."""

from __future__ import annotations

import pytest

import _perfbench_tiny  # noqa: F401  (paths)
from harness import instrument, spec, trace


def X(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def events():
    return [
        X("user_annotation", "bench.window", 0, 100),
        # the table layer launches k1 at t = 12 and k2 at t = 30
        X("user_annotation", "bench.table", 10, 30),
        X("cpu_op", "aten::sort", 11, 5),
        X("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        X("cuda_runtime", "cudaLaunchKernel", 30, 1, corr=2),
        # the tower's forward launches k3; the backward, on thread 2, k4
        X("user_annotation", "bench.tower", 50, 10),
        X("cuda_runtime", "cudaLaunchKernel", 52, 1, corr=3),
        X("cpu_op", "autograd::engine::evaluate_function: AddmmBackward0", 60, 10, tid=2),
        X("cuda_runtime", "cudaLaunchKernel", 61, 1, tid=2, corr=4),
        # a launch outside any layer (an input copy)
        X("cuda_runtime", "cudaMemcpyAsync", 2, 1, corr=5),
        X("cpu_op", "aten::item", 80, 15),
        # device side: k1 [20, 30), k2 [25, 40) overlaps it, k3 [55, 60),
        # k4 [62, 70), the copy [3, 5), and a kernel past the window's end
        X("kernel", "k1", 20, 10, tid=7, corr=1),
        X("kernel", "k2", 25, 15, tid=8, corr=2),
        X("kernel", "k3", 55, 5, tid=7, corr=3),
        X("kernel", "k4", 62, 8, tid=7, corr=4),
        X("gpu_memcpy", "Memcpy HtoD", 3, 2, tid=7, corr=5),
        X("kernel", "late", 95, 10, tid=7),
    ]


def test_layers_busy_and_gaps():
    tl = trace.timeline(events(), instrument.layer_of)
    assert tl.window_us == (0.0, 100.0)
    assert tl.layer_us == {"table": 25.0, "tower": 13.0, "": 7.0}
    # busy: [3, 5) [20, 40) [55, 60) [62, 70) [95, 100)
    assert tl.busy_us == 2 + 20 + 5 + 8 + 5
    assert dict(tl.device_ops)["k2"] == 15.0 and dict(tl.device_ops)["late"] == 5.0
    gaps = dict(tl.idle_gaps)
    # [0, 3): 0-2 outside, 2-3 in the copy's launch; [5, 20): 5-10 outside,
    # 10-11 in bench.table, 11-12 and 13-16 in aten::sort, 12-13 in its
    # launch, 16-20 in bench.table;
    # [40, 55): 40-50 outside, 50-52 and 53-55 in bench.tower, 52-53 in its
    # launch; [60, 62) and [70, 80) outside; [80, 95) in aten::item
    assert gaps == {"host outside any op": 2 + 5 + 10 + 2 + 10, "cudaMemcpyAsync": 1,
                    "bench.table": 1 + 4, "aten::sort": 4, "bench.tower": 4,
                    "cudaLaunchKernel": 2, "aten::item": 15}


def test_reading_and_readers():
    tl = trace.timeline(events(), instrument.layer_of)
    r = trace.Reading(tl, units=2, kind="NVIDIA H100 80GB HBM3", flops_per_unit=67e12 * 1e-6,
                      table_bytes_per_unit=3.35e12 * 5e-6)
    cell = spec.load_cell("dlrm-kaggle.train", _perfbench_tiny.ROOT)
    got = {m.name: cell.reader(m.name)(r) for m in cell.per_layer}
    assert got["table.device_ms"] == pytest.approx(0.0125)
    assert got["tower.device_ms"] == pytest.approx(0.0065)
    assert got["device.idle_share.train"] == pytest.approx(60.0)
    # 1 us of peak work a step over 50 us a step: 2%
    assert got["train.step_mfu"] == pytest.approx(2.0)
    # 5 us of bytes at the peak over 12.5 us of table time a step: 40%
    assert got["table_roofline"] == pytest.approx(40.0)


def test_readers_find_nothing_on_a_cpu_trace():
    evs = [X("user_annotation", "bench.window", 0, 100), X("cpu_op", "aten::mm", 1, 5)]
    r = trace.Reading(trace.timeline(evs, instrument.layer_of), units=3, kind="cpu",
                      flops_per_unit=1.0, table_bytes_per_unit=1.0)
    cell = spec.load_cell("dlrm-kaggle.train", _perfbench_tiny.ROOT)
    assert all(cell.reader(m.name)(r) is None for m in cell.per_layer)


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(ValueError):
        trace.timeline([X("kernel", "k", 0, 1)], instrument.layer_of)
