"""Online scoring of group checkpoints (port of
`meepoembedding_tpu/serving_group.py`, on one device).

`GroupScoringService` restores a group checkpoint (group.json, one
checkpoint a member, the dense head) into a `GroupTrainer` and scores
request batches with probe-only lookups through its `eval_step`: nothing
is inserted, unknown ids give zero embeddings, multi-hot bags pool with
model.combiner. It has the score / reload / stats / metrics_text surface
of `serving.ScoringService`, so `serving.make_http_server` serves it.
Request batches pad to a power of two, as the reference's do.

`distributed=True` (members row-sharded over a mesh) is not ported: it
waits for `ShardedGroupTrainer` (ROADMAP, queue 1, "parallel/ for
groups").
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np

from meepoembedding_tpu_torch.table import hashing


class GroupScoringService:
    def __init__(self, ckpt_path: str, run_cfg, table_cfgs: Dict[str, object],
                 feature_map: Sequence[str], model_cfg, distributed: bool = False, mesh=None,
                 device="cuda"):
        if distributed:
            raise NotImplementedError(
                "GroupScoringService(distributed=True) is not ported yet (ROADMAP.md, queue 1, "
                "'parallel/ for groups': ShardedGroupTrainer and the groups' sharded serving)")
        self._args = (run_cfg, dict(table_cfgs), list(feature_map), model_cfg)
        self.device = device
        self.distributed = distributed
        self._ckpt_path = ckpt_path
        self._lock = threading.Lock()  # one device; serialize requests
        self._lat_ms: list = []
        self._requests = 0
        self.route_drops = 0  # always 0 on one device; kept for the reference's stats
        self.S = 1
        self.trainer, self.manifest = self._restore(ckpt_path)

    def _restore(self, path: str):
        """A fresh trainer restored from `path`; the caller swaps it in, so a
        reload keeps serving the old state until the new one is up."""
        from meepoembedding_tpu_torch.group_train import GroupTrainer

        run_cfg, tables, fmap, model_cfg = self._args
        tr = GroupTrainer(run_cfg, tables, fmap, model_cfg, device=self.device)
        return tr, tr.load_checkpoint(path)

    def score(self, dense, ids) -> np.ndarray:
        """[B, ND] f32 + [B, S] or [B, S, L] int64 -> [B] probabilities."""
        dense = np.asarray(dense, np.float32)
        ids = np.asarray(ids, np.int64)
        t0 = time.perf_counter()
        with self._lock:
            b = len(dense)
            bp = 1 << max(0, (b - 1).bit_length())
            if bp != b:
                dense = np.concatenate(
                    [dense, np.zeros((bp - b,) + dense.shape[1:], np.float32)])
                ids = np.concatenate(
                    [ids, np.full((bp - b,) + ids.shape[1:], hashing.EMPTY_ID, np.int64)])
            out = self.trainer.eval_step(
                {"dense": dense, "ids": ids, "label": np.zeros((bp,), np.float32)})
            logits = out["logits"].cpu().numpy().astype(np.float64)
            p = 1.0 / (1.0 + np.exp(-logits))
            self._requests += 1
            self._lat_ms.append((time.perf_counter() - t0) * 1e3)
            if len(self._lat_ms) > 1024:
                del self._lat_ms[:512]
            return p[:b].astype(np.float32)

    def reload(self, ckpt_path: Optional[str] = None) -> dict:
        path = ckpt_path or self._ckpt_path
        trainer, manifest = self._restore(path)
        with self._lock:
            self.trainer, self.manifest = trainer, manifest
            self._ckpt_path = path
        return self.stats()

    def metrics_text(self) -> str:
        lines = [
            "# TYPE meepo_requests_total counter",
            f"meepo_requests_total {self._requests}",
            "# TYPE meepo_route_drops_total counter",
            f"meepo_route_drops_total {self.route_drops}",
            "# TYPE meepo_mesh_devices gauge",
            f"meepo_mesh_devices {self.S}",
        ]
        for tname, c in self.trainer.counters().items():
            for name, v in c.items():
                lines.append(f"# TYPE meepo_table_{name}_total counter")
                lines.append(f'meepo_table_{name}_total{{table="{tname}"}} {v}')
        if self._lat_ms:
            a = np.asarray(self._lat_ms)
            lines.append("# TYPE meepo_score_latency_ms summary")
            for q in (0.5, 0.95, 0.99):
                lines.append(
                    f'meepo_score_latency_ms{{quantile="{q}"}} {float(np.quantile(a, q)):.3f}')
        return "\n".join(lines) + "\n"

    def stats(self) -> dict:
        c = self.trainer.counters()
        return {
            "ok": True,
            "rows": int(sum(t["rows"] for t in c.values())),
            "tables": {n: t["rows"] for n, t in c.items()},
            "step": int(self.manifest.get("step", self.trainer.step)),
            "devices": self.S,
            "route_drops": self.route_drops,
        }
