"""The serving path's throughput and latency (port of the root
`bench_serving.py`): `ScoringService` on a synthetic checkpoint, over the
f32 dynamic table, the int8 `QuantizedTable`, and a
`ShardedScoringService` over the process group's ranks (a world of one on
one device, as the reference's `make_mesh()` on its one chip: it prices
the service and its exchange wrapper, not a wire).

    python -m meepoembedding_tpu_torch.bench.serving [--device cuda|cpu]

Prints one JSON line a mode, the reference's: {"mode": "f32" | "int8" |
"sharded_S<S>", "scores_per_sec", "p50_ms", "p99_ms", "table_mb"}. A
request's time runs from its numpy inputs to its numpy scores (the host
copy is its barrier); the first request is a warm-up. `table_mb` is the
table's device bytes: the planes of the f32 table (S of them sharded), or
the int8 table's ids, codes and side plane. The int8 figure is 56 bytes a
row at dim 32 against the reference's 44: the port keeps int64 ids (the
reference's are int32, truncating ids of 2^31 and above; the port answers
them exactly) and a copy of them in the side plane, which one gather reads
with the row's scale and zero.

Env knobs, the reference's: MEEPO_SRV_ROWS (rows of the checkpoint, 2^20),
MEEPO_SRV_BATCH (512 examples a request), MEEPO_SRV_STEPS (50 requests),
MEEPO_SRV_DIM (32).
"""

from __future__ import annotations

import json
import shutil
import tempfile
import time

import numpy as np

from meepoembedding_tpu_torch.bench._common import (
    MULT,
    hbm_bytes,
    knob,
    log,
    parse_device,
    start,
    world,
)
from meepoembedding_tpu_torch.config import ModelConfig, TableConfig
from meepoembedding_tpu_torch.serving import ScoringService
from meepoembedding_tpu_torch.serving_sharded import ShardedScoringService
from meepoembedding_tpu_torch.table.runtime import DynamicEmbeddingTable


def run(device="cuda", rows=None, batch=None, steps=None, dim=None) -> dict:
    """The harness in this process; returns {mode: its JSON line's dict},
    in the reference's order. Each argument left None reads the
    reference's environment variable."""
    rows = knob(rows, "MEEPO_SRV_ROWS", 1 << 20)
    batch = knob(batch, "MEEPO_SRV_BATCH", 512)
    steps = knob(steps, "MEEPO_SRV_STEPS", 50)
    dim = knob(dim, "MEEPO_SRV_DIM", 32)
    dev = start(device)
    nd, ns = 4, 8
    table_cfg = TableConfig(dim=dim, capacity=1 << max(10, rows.bit_length()))
    model_cfg = ModelConfig(kind="ctr_mlp", num_dense_features=nd, num_sparse_features=ns,
                            embedding_dim=dim, top_mlp=(64, 1))

    log(f"building {rows}-row checkpoint (dim {dim})...")
    t = DynamicEmbeddingTable(table_cfg, device=dev)
    ids_all = np.arange(1, rows + 1, dtype=np.int64) * MULT
    for o in range(0, rows, 1 << 18):
        t.lookup(ids_all[o:o + (1 << 18)])
    ck = tempfile.mkdtemp(prefix="meepo_srv_bench_")
    out = {}
    try:
        t.save(ck)
        del t
        rng = np.random.default_rng(0)

        def batches():
            for _ in range(steps):
                yield (rng.normal(size=(batch, nd)).astype(np.float32),
                       ids_all[rng.integers(0, rows, size=(batch, ns))])

        def run_one(mode, svc, mb):
            svc.score(*next(iter(batches())))  # warm-up
            lat = []
            t0 = time.perf_counter()
            for dense, ids in batches():
                s0 = time.perf_counter()
                svc.score(dense, ids)
                lat.append((time.perf_counter() - s0) * 1e3)
            dt = time.perf_counter() - t0
            out[mode] = {
                "mode": mode,
                "scores_per_sec": round(steps * batch / dt, 1),
                "p50_ms": round(float(np.percentile(lat, 50)), 2),
                "p99_ms": round(float(np.percentile(lat, 99)), 2),
                "table_mb": round(mb, 1),
            }

        for mode, q in (("f32", "none"), ("int8", "int8")):
            svc = ScoringService(ck, table_cfg, model_cfg, quantize=q, device=dev)
            mb = (svc.table.nbytes() if q == "int8" else hbm_bytes(svc.table.spec)) / 1e6
            run_one(mode, svc, mb)
            del svc
        with world(dev) as mesh:
            svc = ShardedScoringService(ck, table_cfg, model_cfg, mesh=mesh)
            run_one(f"sharded_S{svc.S}", svc, hbm_bytes(svc.spec) * svc.S / 1e6)
            del svc
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    return out


def main() -> None:
    for line in run(parse_device(__doc__)).values():
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
