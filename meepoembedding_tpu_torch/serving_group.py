"""Online scoring of group checkpoints (port of
`meepoembedding_tpu/serving_group.py`).

`GroupScoringService` restores a group checkpoint (group.json, one
checkpoint a member, the dense head) into a `GroupTrainer` and scores
request batches with probe-only lookups through its `eval_step`: nothing
is inserted, unknown ids give zero embeddings, multi-hot bags pool with
model.combiner. It has the score / reload / stats / metrics_text surface
of `serving.ScoringService`, so `serving.make_http_server` serves it.
Request batches pad to a power of two, as the reference's do.

`distributed=True` restores every member row-sharded over `mesh`
(default: the world) through `ShardedGroupTrainer` and scores through the
members' probe-only exchanges; route drops are counted. As in
`serving_sharded.ShardedScoringService`, each rank scores its own rows of
a request, and every rank calls `score` in lockstep with batches of the
same shape.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np

from meepoembedding_tpu_torch.table import hashing


class GroupScoringService:
    def __init__(self, ckpt_path: str, run_cfg, table_cfgs: Dict[str, object],
                 feature_map: Sequence[str], model_cfg, distributed: bool = False, mesh=None,
                 device="cuda"):
        self._args = (run_cfg, dict(table_cfgs), list(feature_map), model_cfg)
        self.model_cfg, self.num_features = model_cfg, len(feature_map)
        self.device = device
        self.distributed = distributed
        self._mesh = mesh
        self.ckpt_path = ckpt_path
        self._lock = threading.Lock()  # one request at a time
        self._lat_ms: list = []
        self._requests = 0
        self.route_drops = 0  # lifetime: ids scored with zero rows (0 on one device)
        self.install_state(ckpt_path, self.load_state(ckpt_path))
        self.S = self.trainer.S

    def load_state(self, path: str):
        """The first phase of a reload: (a fresh trainer restored from
        `path`, its manifest). Neither the trainer's construction nor its
        restore makes a collective; `install_state` swaps the result in, so
        a reload keeps serving the old state until the new one is up."""
        from meepoembedding_tpu_torch.group_train import GroupTrainer, ShardedGroupTrainer

        run_cfg, tables, fmap, model_cfg = self._args
        if not self.distributed:
            tr = GroupTrainer(run_cfg, tables, fmap, model_cfg, device=self.device)
            return tr, tr.load_checkpoint(path)
        from meepoembedding_tpu_torch.parallel.mesh import make_mesh

        if self._mesh is None:
            self._mesh = make_mesh(device=self.device)
        S = self._mesh.size
        if run_cfg.batch_size % S:
            # the trainer needs batch % S == 0; requests pad themselves, so
            # the configured batch size only has to split
            run_cfg = dataclasses.replace(run_cfg, batch_size=max(S, run_cfg.batch_size // S * S))
        tr = ShardedGroupTrainer(run_cfg, tables, fmap, model_cfg, mesh=self._mesh,
                                 device=self.device)
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
            self.route_drops += int(out.get("route_drops", 0))
            logits = out["logits"].cpu().numpy().astype(np.float64)
            p = 1.0 / (1.0 + np.exp(-logits))
            self._requests += 1
            self._lat_ms.append((time.perf_counter() - t0) * 1e3)
            if len(self._lat_ms) > 1024:
                del self._lat_ms[:512]
            return p[:b].astype(np.float32)

    def install_state(self, path: str, state) -> None:
        """The second phase of a reload: swap in a `load_state` result."""
        with self._lock:
            self.trainer, self.manifest = state
            self.ckpt_path = path

    def reload(self, ckpt_path: Optional[str] = None) -> dict:
        path = ckpt_path or self.ckpt_path
        self.install_state(path, self.load_state(path))
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
