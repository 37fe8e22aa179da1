"""The maintenance sweep's cost at scale (port of the root
`bench_evict.py`): one `evict_pass` over a full table when nothing is cold
(the scan every tick pays), when every row is cold (the scan plus the
exports' gathers and the clearing sets), and over a rotating window of
buckets (`policy.evict_scan_buckets`, the production setting for large
tables).

    python -m meepoembedding_tpu_torch.bench.evict [--device cuda|cpu]

Prints one JSON line, the reference's: {"metric": "evict_pass_ms",
"capacity", "dim", "dtype", "live_rows", "scan_only_ms",
"with_exports_ms", "windowed_ms", "window_buckets", "max_evict_per_pass",
"evicted_rich"}. Each time is the best of the repetitions, each pass
timed to the device's end of it.

Env knobs, the reference's: MEEPO_BENCH_CAP (2^25), MEEPO_BENCH_DTYPE
(float32), MEEPO_BENCH_DIM (32), MEEPO_EVICT_FILL (0.8), MEEPO_EVICT_REPS
(10), MEEPO_EVICT_WINDOW (buckets a window, 2^13).
"""

from __future__ import annotations

import dataclasses
import json
import time

import torch

from meepoembedding_tpu_torch.bench._common import (
    device_kind,
    knob,
    log,
    parse_device,
    prefill,
    require,
    start,
    sync,
    zero_grads,
)
from meepoembedding_tpu_torch.config import OptimizerConfig, PolicyConfig, TableConfig
from meepoembedding_tpu_torch.table import table_ops
from meepoembedding_tpu_torch.table.layout import TableSpec, alloc_shard


def run(device="cuda", cap=None, dim=None, dtype=None, fill=None, reps=None,
        window=None) -> dict:
    """The harness in this process; returns the JSON line's dict. Each
    argument left None reads the reference's environment variable."""
    cap = knob(cap, "MEEPO_BENCH_CAP", 1 << 25)
    dim = knob(dim, "MEEPO_BENCH_DIM", 32)
    vdtype = knob(dtype, "MEEPO_BENCH_DTYPE", "float32", str)
    fill = knob(fill, "MEEPO_EVICT_FILL", 0.8, float)
    reps = knob(reps, "MEEPO_EVICT_REPS", 10)
    K = knob(window, "MEEPO_EVICT_WINDOW", 1 << 13)
    dev = start(device)
    cfg = TableConfig(
        dim=dim, capacity=cap, value_dtype=vdtype,
        optimizer=OptimizerConfig(kind="rowwise_adagrad", learning_rate=0.05),
        policy=PolicyConfig(evict_policy="lfu_ttl", ttl_steps=1 << 20, lfu_min_freq=0,
                            max_evict_per_pass=1 << 14),
        max_probe_rounds=2,
    )
    spec = TableSpec.from_config(cfg)
    log(f"device={device_kind(dev)} cap={cap} dim={dim} {vdtype}")
    shard = alloc_shard(spec, dev)
    n_live = int(cap * fill)
    t0 = time.perf_counter()
    prefill(spec, shard, n_live, 1 << 20, 1, grads=zero_grads)
    int(shard.counters[0])
    log(f"prefill {n_live} rows in {time.perf_counter() - t0:.1f}s")

    def timed(sp, step, cursor=None):
        """`reps` passes at `step`; with a cursor, over successive windows.
        Returns (best ms, rows evicted over the passes)."""
        times, total = [], 0
        for _ in range(reps):
            t0 = time.perf_counter()
            export = table_ops.evict_pass(sp, shard, step, cursor)
            total += export.count  # read on the host mid-pass (its selection)
            sync(dev)  # the exports' gathers and the clears: the pass's end
            times.append(time.perf_counter() - t0)
            if cursor is not None:
                cursor = table_ops.next_evict_cursor(sp, cursor)
        return min(times) * 1e3, total

    with torch.no_grad():
        # the common case, nothing cold: the scan every maintenance tick pays
        scan_ms, n0 = timed(spec, 2)
        log(f"{'evict_pass, 0 candidates':34s} best {scan_ms:8.2f} ms  "
            f"(evicted {n0} over {reps} reps)")
        require(n0 == 0, f"{n0} rows evicted where none is cold")
        # candidate-rich: the TTL expires every row, so each pass exports and
        # clears max_evict_per_pass rows
        rich_ms, n1 = timed(spec, (1 << 20) + 10)
        log(f"{'evict_pass, full candidates':34s} best {rich_ms:8.2f} ms  "
            f"(evicted {n1} over {reps} reps)")
        spec_w = dataclasses.replace(
            spec, policy=dataclasses.replace(spec.policy, evict_scan_buckets=K))
        win_ms, got = timed(spec_w, 3, 0)
        log(f"{'evict_pass, K=' + str(K) + ' window':34s} best {win_ms:8.2f} ms "
            f"(evicted {got})")
    return {
        "metric": "evict_pass_ms",
        "capacity": cap, "dim": dim, "dtype": vdtype, "live_rows": n_live,
        "scan_only_ms": round(scan_ms, 2),
        "with_exports_ms": round(rich_ms, 2),
        "windowed_ms": round(win_ms, 2),
        "window_buckets": K,
        "max_evict_per_pass": cfg.policy.max_evict_per_pass,
        "evicted_rich": n1,
    }


def main() -> None:
    print(json.dumps(run(parse_device(__doc__))), flush=True)


if __name__ == "__main__":
    main()
