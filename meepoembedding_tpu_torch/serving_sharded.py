"""Row-sharded online scoring (port of `meepoembedding_tpu/serving_sharded.py`).

`ShardedScoringService` restores a checkpoint written with any shard
count across the ranks of a mesh, each rank building only its own shard,
and scores request batches through the probe-only exchange
(`sharded_table.exchange_lookup(train=False)`): ids dedup on the rank,
route to their owners, and their rows come back; unknown ids give zero
rows, and ids past the exchange's capacity are counted (`route_drops`,
surfaced in /metrics: a dropped id scores with a zero row).

Each rank scores its own rows of a request (the reference's multi-process
path), and every rank calls `score` with batches of the same shape, since
the exchange is a collective. The service has the score / reload / stats /
metrics_text surface of `serving.ScoringService`, so at a world of one
`serving.make_http_server` serves it (POST /score, /reload, GET /healthz,
/metrics), and `lookup` lets a `RetrievalService` build over it.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch

from meepoembedding_tpu_torch import checkpoint
from meepoembedding_tpu_torch.models import build_model
from meepoembedding_tpu_torch.models.common import model_apply, model_inputs
from meepoembedding_tpu_torch.ops import dedup
from meepoembedding_tpu_torch.parallel import sharded_table as st
from meepoembedding_tpu_torch.parallel.mesh import Mesh, make_mesh
from meepoembedding_tpu_torch.parallel.trainer import SHARDED_COUNTER_NAMES, sum_ints
from meepoembedding_tpu_torch.table import hashing
from meepoembedding_tpu_torch.table.layout import TableSpec
from meepoembedding_tpu_torch.weights import from_jax_params


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


class ShardedScoringService:
    """Row-sharded, probe-only scoring over a mesh (default: the world on
    `device`)."""

    def __init__(self, ckpt_path: str, table_cfg, model_cfg, mesh: Optional[Mesh] = None,
                 a2a_factor: float = 1.25, device="cuda"):
        self.mesh = mesh or make_mesh(device=device)
        self.S, self.device = self.mesh.size, self.mesh.device
        self.table_cfg, self.model_cfg = table_cfg, model_cfg
        self.a2a_factor = a2a_factor
        self._ckpt_path = ckpt_path
        self._lock = threading.Lock()  # one exchange at a time
        self._lat_ms: list = []
        self._requests = 0
        self.route_drops = 0  # lifetime: ids scored with zero rows
        self.spec, self.shard, self.model, self.manifest = self._restore(ckpt_path)

    def _restore(self, path: str):
        """(spec, this rank's shard, tower, manifest) of a checkpoint: its
        rows rehashed to their owners at this S. A growable table config
        first grows to fit the saved rows; a fixed one that cannot hold them
        raises. The caller swaps the result in, so a reload keeps serving
        the old state until the new one is up."""
        m = checkpoint.read_manifest(path)
        total = sum(m.get("counts", [0]))
        cfg = self.table_cfg
        spec = TableSpec.from_config(cfg, num_shards=self.S)
        while cfg.grow_at_load is not None and total > cfg.grow_at_load * spec.capacity * self.S:
            cfg = dataclasses.replace(cfg, capacity=cfg.capacity * 2)
            spec = TableSpec.from_config(cfg, num_shards=self.S)
        checkpoint.check_manifest(spec, m)
        shards, manifest = checkpoint.restore_shards(spec, path, self.S, device=self.device,
                                                     only_ids={self.mesh.rank})
        self.table_cfg = cfg
        # without saved params, a He-init from torch seed 0 (as ScoringService)
        model = build_model(self.model_cfg, generator=torch.Generator().manual_seed(0))
        if "params" in manifest.get("dense", []):
            from_jax_params(model, checkpoint.load_dense(path, "params"))
        return spec, shards[self.mesh.rank], model.to(self.device).eval(), manifest

    def _exchange(self, ids: np.ndarray):
        """Probe-only rows of this rank's ids [n] int64 (n a power of two):
        (rows [n, dim] f32 in input order, the global route drops)."""
        ids_t = torch.from_numpy(ids).to(self.device)
        hi, lo = hashing.split_ids_t(ids_t)
        n = ids.shape[0]
        uniq = dedup.unique_pairs(hi, lo, n)
        emb_u, ctx = st.exchange_lookup(self.spec, self.shard, uniq.hi, uniq.lo, uniq.valid, 0,
                                        self.mesh, st.a2a_capacity(n, self.S, self.a2a_factor),
                                        train=False)
        rows = dedup.GatherRows.apply(emb_u, uniq.inverse)
        return rows, int(sum_ints(ctx.n_drop, self.mesh))

    def score(self, dense, ids) -> np.ndarray:
        """This rank's rows: [B, ND] f32 + [B, S] or [B, S, L] int64 -> [B]
        probabilities. B pads to a power of two with the invalid id (and
        zero dense features), which bounds the exchange's shapes; the
        padding is cut from the reply."""
        dense = np.asarray(dense, np.float32)
        ids = np.asarray(ids, np.int64)
        t0 = time.perf_counter()
        with self._lock, torch.no_grad():
            b = len(dense)
            bp = _pow2(b)
            if bp != b:
                dense = np.concatenate([dense, np.zeros((bp - b,) + dense.shape[1:], np.float32)])
                ids = np.concatenate(
                    [ids, np.full((bp - b,) + ids.shape[1:], hashing.EMPTY_ID, np.int64)])
            rows, drops = self._exchange(ids.reshape(-1))
            bag_valid = None
            if ids.ndim == 3:
                bag_valid = hashing.is_valid(*hashing.split_ids_t(torch.from_numpy(ids)
                                                                  .to(self.device)))
            emb = model_inputs(self.model, rows, ids.shape, bag_valid, self.spec.dim,
                               self.model_cfg.combiner)
            dense_t = torch.from_numpy(dense).to(self.device)
            out = torch.sigmoid(model_apply(self.model, dense_t, emb, bag_valid)).cpu().numpy()
            self.route_drops += drops
            self._requests += 1
            self._lat_ms.append((time.perf_counter() - t0) * 1e3)
            if len(self._lat_ms) > 1024:
                del self._lat_ms[:512]
            return out[:b]

    @property
    def table(self):
        """`RetrievalService` reads rows through `scoring.table.lookup`; the
        sharded table is this service."""
        return self

    def lookup(self, ids64, train: bool = False) -> torch.Tensor:
        """[n] int64 -> [n, dim] f32 rows on the rank's device through the
        probe-only exchange; absent ids give zero rows. n pads to a power of
        two."""
        if train:
            raise ValueError("sharded serving is probe-only")
        ids = np.asarray(ids64, np.int64).reshape(-1)
        n = len(ids)
        ids_p = np.full((_pow2(n),), hashing.EMPTY_ID, np.int64)
        ids_p[:n] = ids
        with self._lock, torch.no_grad():
            rows, drops = self._exchange(ids_p)
            self.route_drops += drops
        return rows[:n]

    # --- lifecycle ----------------------------------------------------------
    def reload(self, ckpt_path: Optional[str] = None) -> dict:
        """Hot-swap to a checkpoint: the replacement is restored off the
        serving lock, then swapped in at once. Raises on a bad checkpoint,
        leaving the old state serving."""
        path = ckpt_path or self._ckpt_path
        spec, shard, model, manifest = self._restore(path)
        with self._lock:
            self.spec, self.shard, self.model, self.manifest = spec, shard, model, manifest
            self._ckpt_path = path
        return self.stats()

    def counters(self) -> dict:
        """The table counters summed over the ranks; route_drops also counts
        the probes' drops, which leave the shards untouched."""
        c = sum_ints(self.shard.counters, self.mesh).cpu()
        out = {n: int(c[i]) for i, n in enumerate(SHARDED_COUNTER_NAMES)}
        out["route_drops"] = max(out["route_drops"], self.route_drops)
        return out

    def __len__(self) -> int:
        return int(sum_ints(self.shard.cnt.sum(), self.mesh))

    def metrics_text(self) -> str:
        """Prometheus text: the single-device service's families, the mesh
        size and the route drops."""
        lines = [
            "# TYPE meepo_table_rows gauge",
            f"meepo_table_rows {len(self)}",
            "# TYPE meepo_mesh_devices gauge",
            f"meepo_mesh_devices {self.S}",
            "# TYPE meepo_requests_total counter",
            f"meepo_requests_total {self._requests}",
            "# TYPE meepo_route_drops_total counter",
            f"meepo_route_drops_total {self.route_drops}",
        ]
        for name, v in self.counters().items():
            lines.append(f"# TYPE meepo_table_{name}_total counter")
            lines.append(f"meepo_table_{name}_total {v}")
        if self._lat_ms:
            a = np.asarray(self._lat_ms)
            lines.append("# TYPE meepo_score_latency_ms summary")
            for q in (0.5, 0.95, 0.99):
                lines.append(
                    f'meepo_score_latency_ms{{quantile="{q}"}} {float(np.quantile(a, q)):.3f}')
        return "\n".join(lines) + "\n"

    def stats(self) -> dict:
        return {
            "ok": True,
            "rows": len(self),
            "step": int(self.manifest.get("step", 0)),
            "dim": self.table_cfg.dim,
            "devices": self.S,
            "route_drops": self.route_drops,
        }
