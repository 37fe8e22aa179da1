"""Each stage of the table's hot path timed alone (port of the root
`bench_stages.py`): dedup, probe, find-or-insert, gather, inverse gather,
segment sum, the optimizer update and its three parts, so that a
regression can be traced to its stage.

    python -m meepoembedding_tpu_torch.bench.stages [--device cuda|cpu]

Logs one line a stage, `name  ms`, as the reference does, and prints one
JSON line with the same names and times: {"metric": "hot_path_stages_ms",
..., "stages": [{"name", "reference", "ms"}, ...]}, where "reference" is
the reference's name for the stage. A stage's time is the mean of 10
calls after one warm-up call, the host waiting for the device
(`torch.cuda.synchronize`) where the reference blocks.

The ids are uniform over the live keys and the dedup's capacity is the
batch, as in the reference. Its stages map to the port's so:
"find_or_insert (all-hit)" is `lookup_train` on ids that all hit; the
update's parts `gather_bucket_plane`, `scatter_bucket_plane` and
`row_apply_delta` are the accumulator's gather (`row_gather` of its flat
plane), its set (`row_scatter_set`) and the values add (`row_merge_add`).
The reference's TPU sub-stages (`combine_rows_by_vrow`,
`sorted_run_sums`, a [n, 128] cumsum, `argsort`) have no counterpart in
the port: one log line says so, with no time.

Env knobs, the reference's: MEEPO_BENCH_CAP (2^22), MEEPO_BENCH_BATCH
(2^19), MEEPO_BENCH_DIM (32).
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from meepoembedding_tpu_torch.bench._common import (
    MULT,
    device_kind,
    knob,
    log,
    parse_device,
    prefill,
    start,
    sync,
    to_device,
)
from meepoembedding_tpu_torch.config import OptimizerConfig, TableConfig
from meepoembedding_tpu_torch.kernels import row_gather
from meepoembedding_tpu_torch.ops import dedup, optim
from meepoembedding_tpu_torch.table import table_ops
from meepoembedding_tpu_torch.table.layout import TableSpec, alloc_shard

# (the port's name, the reference's), in the reference's order
STAGES = (
    ("dedup.unique_pairs", "dedup.unique_pairs"),
    ("probe (all-hit)", "probe (all-hit)"),
    ("lookup_train (all-hit)", "find_or_insert (all-hit)"),
    ("lookup_rows (gather)", "lookup_rows (gather)"),
    ("inverse gather [n,dim]", "inverse gather [n,dim]"),
    ("segment_sum_grads", "segment_sum_grads"),
    ("apply_sparse_grads (adagrad)", "apply_sparse_grads (adagrad)"),
    ("  accumulator gather (row_gather)", "  gather_bucket_plane (accum)"),
    ("  accumulator set (row_scatter_set)", "  scatter_bucket_plane (accum)"),
    ("  values add (row_merge_add)", "  row_apply_delta (values)"),
)
NOT_PORTED = ("combine_rows_by_vrow", "sorted_run_sums", "cumsum [n,128] f32",
              "argsort [n] i32")


def run(device="cuda", cap=None, batch=None, dim=None) -> dict:
    """The harness in this process; returns the JSON line's dict. Each
    argument left None reads the reference's environment variable."""
    cap = knob(cap, "MEEPO_BENCH_CAP", 1 << 22)
    batch = knob(batch, "MEEPO_BENCH_BATCH", 1 << 19)
    dim = knob(dim, "MEEPO_BENCH_DIM", 32)
    dev = start(device)
    spec = TableSpec.from_config(TableConfig(
        dim=dim, capacity=cap,
        optimizer=OptimizerConfig(kind="rowwise_adagrad", learning_rate=0.05)))
    log(f"device={device_kind(dev)} cap={cap} batch={batch} dim={dim}")
    shard = alloc_shard(spec, dev)
    n_live = int(cap * 0.8)
    pf = min(batch, 1 << 19)
    # whole batches, as the reference's: up to one batch past n_live
    prefill(spec, shard, -(-n_live // pf) * pf, pf, 0)
    sync(dev)
    log(f"prefilled {n_live}")

    rng = np.random.default_rng(0)
    hi, lo = to_device(rng.integers(0, n_live, size=batch) * MULT, dev)
    times = []

    def timeit(name, fn, *args, steps=10):
        fn(*args)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            fn(*args)
        sync(dev)
        dt = (time.perf_counter() - t0) / steps * 1e3
        times.append(dt)
        log(f"{name:34s} {dt:9.3f} ms")

    with torch.no_grad():
        names = iter(n for n, _ in STAGES)
        uniq = dedup.unique_pairs(hi, lo, batch)
        timeit(next(names), dedup.unique_pairs, hi, lo, batch)
        pr = table_ops.probe(spec, shard, uniq.hi, uniq.lo, uniq.valid)
        timeit(next(names), table_ops.probe, spec, shard, uniq.hi, uniq.lo, uniq.valid)
        slot = pr.slot
        timeit(next(names), table_ops.lookup_train, spec, shard, uniq.hi, uniq.lo, uniq.valid,
               1)
        rows = table_ops.lookup_rows(shard, slot)
        timeit(next(names), table_ops.lookup_rows, shard, slot)
        timeit(next(names), row_gather, rows, uniq.inverse)
        g = rows * 1e-3
        gu = dedup.segment_sum_grads(g, uniq.inverse, batch, uniq.order, uniq.sorted_ids)
        timeit(next(names), dedup.segment_sum_grads, g, uniq.inverse, batch, uniq.order,
               uniq.sorted_ids)
        timeit(next(names), optim.apply_sparse_grads, spec, shard, slot, gu)

        # the update's parts
        accum = shard.opt_rowwise[0].view(-1, 1)
        timeit(next(names), row_gather, accum, slot)
        a = row_gather(accum, slot).view(-1)
        on = table_ops.set_index(slot, slot >= 0)
        timeit(next(names), table_ops.scatter_bucket_planes, on, [(shard.opt_rowwise[0], a)])
        timeit(next(names), table_ops.scatter_add_values, shard.values, slot, gu, slot >= 0)
    log(f"  {', '.join(NOT_PORTED)}: TPU sub-stages, no counterpart in the port")
    return {
        "metric": "hot_path_stages_ms", "capacity": cap, "batch": batch, "dim": dim,
        "stages": [{"name": n, "reference": r, "ms": round(ms, 4)}
                   for (n, r), ms in zip(STAGES, times)],
    }


def main() -> None:
    print(json.dumps(run(parse_device(__doc__))), flush=True)


if __name__ == "__main__":
    main()
