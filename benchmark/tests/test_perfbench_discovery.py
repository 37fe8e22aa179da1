"""Discovery by name: a configuration, a mix, a cell and a metric added as
files, with entries in BENCHMARK.json, make a runnable cell with no code
edited; and the repository's own BENCHMARK.json is complete."""

from __future__ import annotations

import json
import shutil

import _perfbench_tiny  # noqa: F401  (paths)
from harness import spec, trace


def test_every_cell_of_the_repository_resolves():
    bench = json.loads((_perfbench_tiny.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], _perfbench_tiny.ROOT)
        assert cell.loop in ("closed", "open") and cell.limits
        assert spec.reference(cell.config).__name__ == "reference.dlrm"
        assert {m.name for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(cell.reader(m.name))
            assert any(e.name == m.moves for e in cell.end_to_end)


def test_new_files_make_a_runnable_cell(tmp_path):
    src = _perfbench_tiny.BENCH
    data = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "cells", "metrics"):
        (data / sub).mkdir(parents=True)
    cfg = json.loads((src / "configs" / "dlrm-kaggle.json").read_text())
    cfg["name"] = "tiny-dlrm"
    (data / "configs" / "tiny-dlrm.json").write_text(json.dumps(cfg))
    mix = json.loads((src / "traffic" / "train_stream.json").read_text())
    mix["zipf_s"] = 1.2
    (data / "traffic" / "skewed_stream.json").write_text(json.dumps(mix))
    (data / "cells" / "tiny-dlrm.skewed.json").write_text(json.dumps(
        {"batch": 32, "first_sighting_share": 0.1, "limits": {"loss_gap": 1e-5}}))
    (data / "metrics" / "steps_traced.py").write_text(
        "def read(r):\n    return float(r.units)\n")
    shutil.copy(src / "metrics" / "table.device_ms.py", data / "metrics")
    bench = {
        "configs": [{"name": "tiny-dlrm", "file": "benchmark/configs/tiny-dlrm.json"}],
        "workloads": [{"name": "tiny-dlrm.skewed", "config": "tiny-dlrm",
                       "traffic": "skewed_stream", "chips": 1}],
        "end_to_end": [{"name": "setup_s", "unit": "s", "better": "lower",
                        "source": "host_clock"}],
        "per_layer": [{"name": "steps_traced", "unit": "steps", "better": "higher",
                       "source": "program_counter", "moves": "setup_s"},
                      {"name": "table.device_ms", "unit": "ms", "better": "lower",
                       "source": "device_trace", "moves": "setup_s",
                       "workloads": ["another.cell"]}],
    }
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("tiny-dlrm.skewed", tmp_path)
    assert cell.mix["zipf_s"] == 1.2 and cell.mix["batch"] == 32
    assert cell.limits == {"loss_gap": 1e-5} and "limits" not in cell.mix
    assert [m.name for m in cell.per_layer] == ["steps_traced"]
    tl = trace.Timeline((0.0, 1.0), 0.0, {}, [], [], 0)
    assert cell.reader("steps_traced")(trace.Reading(tl, units=7, kind="cpu")) == 7.0
    # the new cell runs through the training cell runner on the CPU
    from harness import train_cell

    cell.config["cardinalities"] = [5 + j for j in range(26)]
    cell.config["table"]["capacity"] = 1 << 12
    cell.mix["pool_batches"] = 2
    tc = train_cell.TrainCell(cell, 3, "cpu")
    tc.first_steps()
    assert tc.window(0.05)["steps"] >= 1
