"""The retrieval path's costs (port of the root `bench_retrieval.py`): the
two-tower's index build rate and exact top-k queries over an item corpus
on the device (`retrieval.ItemIndex`).

    python -m meepoembedding_tpu_torch.bench.retrieval [--device cuda|cpu]

As the reference, it times the towers and the index only: the item and
query rows are random, not table lookups (the headline harness times the
table's path), so no kernel of the port runs here.

Prints one JSON line a phase, the reference's:
  {"phase": "index_build", "items_per_sec", "items"}: the item tower over
    the corpus in batches of 2^14, each batch's vectors copied to the host
    (the barrier); the first batch is a warm-up and is not counted.
  {"phase": "topk", "queries_per_sec", "p50_ms", "p99_ms", "corpus", "k",
    "dim", "index_dtype"}: a request is the query tower over `batch`
    queries and `ItemIndex.topk`, from numpy inputs to numpy keys and
    scores; the first request is a warm-up.

Env knobs, the reference's: MEEPO_RET_ITEMS (2^20), MEEPO_RET_DIM (64, the
item vectors' width, bottom_mlp[-1]), MEEPO_RET_BATCH (256 queries a
request), MEEPO_RET_K (100), MEEPO_RET_STEPS (30), MEEPO_RET_DTYPE
(float32 | bfloat16 index).
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from meepoembedding_tpu_torch.bench._common import knob, log, parse_device, require, start
from meepoembedding_tpu_torch.config import ModelConfig
from meepoembedding_tpu_torch.models import build_model
from meepoembedding_tpu_torch.retrieval import ItemIndex


def run(device="cuda", items=None, dim=None, batch=None, k=None, steps=None,
        dtype=None) -> dict:
    """The harness in this process; returns {phase: its JSON line's dict}.
    Each argument left None reads the reference's environment variable."""
    items = knob(items, "MEEPO_RET_ITEMS", 1 << 20)
    dim = knob(dim, "MEEPO_RET_DIM", 64)
    batch = knob(batch, "MEEPO_RET_BATCH", 256)
    k = knob(k, "MEEPO_RET_K", 100)
    steps = knob(steps, "MEEPO_RET_STEPS", 30)
    idx_dtype = knob(dtype, "MEEPO_RET_DTYPE", "float32", str)
    dev = start(device)
    emb_dim = 32
    mc = ModelConfig(kind="two_tower", num_dense_features=8, num_sparse_features=4,
                     num_query_features=2, embedding_dim=emb_dim,
                     bottom_mlp=(256, 128, dim), top_mlp=(8, 1))
    model = build_model(mc, generator=torch.Generator().manual_seed(0)).to(dev).eval()
    rng = np.random.default_rng(0)
    out = {}

    with torch.no_grad():
        # --- index build: the item tower over the corpus ----------------------
        bb = 1 << 14
        n_pad = -(-items // bb) * bb
        log(f"embedding {items} items (batch {bb})...")
        chunks = []
        t0 = None
        for s in range(0, n_pad, bb):
            rows = rng.normal(size=(bb, mc.num_sparse_features - mc.num_query_features,
                                    emb_dim)).astype(np.float32) * 0.05
            chunks.append(model.embed_item(torch.from_numpy(rows).to(dev)).cpu().numpy())
            if s == 0:  # the warm-up batch is not counted
                t0 = time.perf_counter()
        dt = time.perf_counter() - t0
        out["index_build"] = {"phase": "index_build",
                              "items_per_sec": round(max(n_pad - bb, 1) / dt, 1),
                              "items": items}
        vecs = np.concatenate(chunks)[:items]

        # --- top-k queries ----------------------------------------------------
        index = ItemIndex(vecs, dtype=idx_dtype, device=dev)
        lat = []
        for i in range(steps + 1):
            dense = rng.normal(size=(batch, mc.num_dense_features)).astype(np.float32)
            qrows = rng.normal(size=(batch, mc.num_query_features, emb_dim)
                               ).astype(np.float32) * 0.05
            t0 = time.perf_counter()
            qv = model.embed_query(torch.from_numpy(dense).to(dev),
                                   torch.from_numpy(qrows).to(dev))
            keys, _ = index.topk(qv, k)
            require(keys.shape == (batch, min(k, items)),
                    f"top-k keys of shape {keys.shape}, not {(batch, min(k, items))}")
            if i:  # the first request is a warm-up
                lat.append((time.perf_counter() - t0) * 1e3)
    lat = np.asarray(lat)
    out["topk"] = {
        "phase": "topk",
        "queries_per_sec": round(batch * len(lat) / (lat.sum() / 1e3), 1),
        "p50_ms": round(float(np.percentile(lat, 50)), 3),
        "p99_ms": round(float(np.percentile(lat, 99)), 3),
        "corpus": items, "k": k, "dim": dim, "index_dtype": idx_dtype,
    }
    return out


def main() -> None:
    for line in run(parse_device(__doc__)).values():
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
