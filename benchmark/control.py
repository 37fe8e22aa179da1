"""The readings that the correctness limits are set from, for one cell over
many seeds in one process: the program's numbers (set-up, the first steps
or a short window, against the float32 reference), the control's (the
reference in TF32 in the program's place) and, for training, two planted
faults' (the reference with half of each batch left out and the mean taken
over the rest; the reference with the table rows' update lost).

  python3 benchmark/control.py --workload dlrm-kaggle.train --seeds 11,12,13 \
      [--seconds 4] > readings.jsonl

One JSON line a seed.
"""

from __future__ import annotations

import gc
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (str(HERE), str(HERE.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def half(batches):
    return [{k: v[: len(v) // 2] for k, v in b.items()} for b in batches]


def sparse_lost(cfg: dict) -> dict:
    """The configuration with the table's learning rate 0: rows never move."""
    t = cfg["table"]
    return {**cfg, "table": {**t, "optimizer": {**t["optimizer"], "learning_rate": 0.0}}}


def train_seed(cell, seed, dev) -> dict:
    from harness import train_cell

    tc = train_cell.TrainCell(cell, seed, dev)
    prog = tc.first_steps()
    batches = tc.batches
    tc.free()
    del tc
    gc.collect()
    import torch
    torch.cuda.empty_cache()
    ref32 = train_cell.reference_readings(cell.config, seed, batches, dev)
    ctrl = train_cell.reference_readings(cell.config, seed, batches, dev, kind="tf32")
    fault = train_cell.reference_readings(cell.config, seed, half(batches), dev)
    lost = train_cell.reference_readings(sparse_lost(cell.config), seed, batches, dev)
    return {"program": train_cell.compare(prog, ref32),
            "control": train_cell.compare({**ctrl, "dropped": 0}, ref32),
            "half_batch": train_cell.compare({**fault, "dropped": 0}, ref32),
            "sparse_lost": train_cell.compare({**lost, "dropped": 0}, ref32),
            "leaves": {"program": train_cell.leaf_detail(prog, ref32),
                       "control": train_cell.leaf_detail(ctrl, ref32),
                       "half_batch": train_cell.leaf_detail(fault, ref32)}}


def serve_seed(cell, seed, dev, seconds) -> dict:
    from harness import serve_cell

    sc = serve_cell.ServeCell(cell, seed, dev, seconds)
    w = sc.window(seconds)
    prog, inputs, dropped = sc.answers()
    sc.free()
    del sc
    gc.collect()
    import torch
    torch.cuda.empty_cache()
    ref32 = serve_cell.reference_scores(cell.config, seed, inputs, dev)
    ctrl = serve_cell.reference_scores(cell.config, seed, inputs, dev, kind="tf32")
    return {"program": serve_cell.compare(prog, ref32, w["failed"], dropped),
            "control": serve_cell.compare(ctrl, ref32, 0, 0),
            "logit_abs_p50": float(_logit_p50(ref32))}


def _logit_p50(scores) -> float:
    import numpy as np

    p = np.clip(np.concatenate(scores).astype(np.float64), 1e-12, 1 - 1e-12)
    return float(np.median(np.abs(np.log(p / (1 - p)))))


def main() -> int:
    import argparse

    import torch

    from harness import spec

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    dev = torch.device("cuda:0")
    for seed in (int(s) for s in args.seeds.split(",")):
        if cell.loop == "closed":
            out = train_seed(cell, seed, dev)
        else:
            out = serve_seed(cell, seed, dev, args.seconds)
        print(json.dumps({"workload": cell.name, "seed": seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
