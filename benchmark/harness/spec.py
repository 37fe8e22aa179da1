"""Discovery by name: a cell of `BENCHMARK.json` and the files it names.

  root/BENCHMARK.json                      the cells and metrics
  root/<config file>                       the configuration, as `configs` says
  root/benchmark/traffic/<mix>.json        the mix's parameters
  root/benchmark/cells/<workload>.json     the cell's own parameters and limits
  root/benchmark/metrics/<metric>.py       one reader a per-layer metric
  root/benchmark/reference/<name>.py       the plain reference a configuration
                                           names under `reference`

A later cell, mix, configuration or metric is a new file and a new entry;
no code here names one. Nor does any name a model kind: the configuration's
`model` keys that are fields of the port's `ModelConfig` go to the port
(`program.model_config`); its reference module gives the tower's leaves
(`leaf_specs`), its multiply-adds (`macs_per_example`), and the plain
model the check runs (`reference/__init__.py`); its `multi_hot_sizes` and
`multi_hot_distribution`, if given, make the traffic's features fixed-size
bags (`traffic.Bags`).
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
DATA = "benchmark"


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    workloads: Optional[List[str]]
    layer: Optional[str] = None
    moves: Optional[str] = None

    def applies_to(self, workload: str) -> bool:
        return self.workloads is None or workload in self.workloads


@dataclasses.dataclass
class Cell:
    """One workload of `BENCHMARK.json`, with its files read."""

    name: str
    chips: int
    config: dict  # configs/<name>.json
    mix: dict  # traffic/<mix>.json, then the cell's parameters over it
    limits: Dict[str, float]  # correctness limits, by compared number
    not_compared: List[str]  # numbers reported but not compared (PERF.md says why)
    end_to_end: List[Metric]  # the ones this cell reports
    per_layer: List[Metric]
    root: Path

    @property
    def loop(self) -> str:
        return self.mix["loop"]

    def reader(self, metric: str) -> Callable:
        """The `read(reading)` function of `metrics/<metric>.py`."""
        path = self.root / DATA / "metrics" / f"{metric}.py"
        mod_name = "bench_metric_" + "".join(c if c.isalnum() else "_" for c in metric)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def reference(config: dict):
    """The plain reference module that the configuration names under
    `reference` (a file of `benchmark/reference/`)."""
    path = Path(config["reference"])
    if path.parent.as_posix() != f"{DATA}/reference" or path.suffix != ".py":
        raise ValueError(f"reference {config['reference']!r} is not a file of "
                         f"{DATA}/reference/")
    return importlib.import_module(f"reference.{path.stem}")


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _metric(m: dict) -> Metric:
    return Metric(name=m["name"], unit=m["unit"], better=m["better"], source=m["source"],
                  workloads=m.get("workloads"), layer=m.get("layer"), moves=m.get("moves"))


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell `workload` of `root/BENCHMARK.json`. Raises KeyError for a
    name the file does not hold."""
    bench = _load(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {root / 'BENCHMARK.json'}; "
                       f"known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load(root / configs[w["config"]]["file"])
    mix = _load(root / DATA / "traffic" / f"{w['traffic']}.json")
    own = _load(root / DATA / "cells" / f"{workload}.json")
    limits = own.pop("limits", {})
    not_compared = own.pop("not_compared", [])
    mix = {**mix, **own}
    e2e = [_metric(m) for m in bench["end_to_end"]]
    e2e = [m for m in e2e if m.applies_to(workload)]
    layer = [_metric(m) for m in bench["per_layer"]]
    layer = [m for m in layer if m.applies_to(workload)]
    return Cell(name=workload, chips=int(w["chips"]), config=config, mix=mix, limits=limits,
                not_compared=not_compared, end_to_end=e2e, per_layer=layer, root=root)
