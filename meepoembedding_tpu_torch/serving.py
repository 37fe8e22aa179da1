"""Online scoring service (port of `meepoembedding_tpu/serving.py`).

`ScoringService` restores a checkpoint once (table and dense tower) and
scores request batches with probe-only lookups: no insert on miss, unknown
ids give zero embeddings, multi-hot bags pool with the configured combiner.
`make_http_server` serves it over the standard library's HTTP server:

  POST /score   {"dense": [[...]], "ids": [[...]]}  ->  {"scores": [...]}
  POST /reload  {"ckpt": "/path"} (optional) -> hot-swap to a checkpoint
  POST /retrieve {"dense": [[...]], "ids": [[...]], "k": 10} -> {"keys":
                [[...]], "scores": [[...]]}, with a `RetrievalService`
  GET  /healthz ->  {"ok": true, "rows": N, "step": k, "dim": d}
  GET  /metrics ->  Prometheus text: table counters, rows, request count
                    and latency quantiles

`quantize="int8"` serves from a read-only `serving_quant.QuantizedTable`
instead of the dynamic table; at dim 32 it takes 2.4x fewer bytes than
the f32 rows and their ids.

Not in the reference: multi-hot bags go the ragged way, as the trainer's
do (`train.py`, `pooling.takes_ragged`), from the dynamic table: only the
valid ids are probed, and `dedup.GatherRows` pools the bags from the unique
rows. The int8 table, which has no unique-id lookup, reads padded bags.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from meepoembedding_tpu_torch import checkpoint
from meepoembedding_tpu_torch.models import build_model
from meepoembedding_tpu_torch.models.common import model_apply, model_inputs
from meepoembedding_tpu_torch.ops import dedup, pooling
from meepoembedding_tpu_torch.serving_quant import QuantizedTable
from meepoembedding_tpu_torch.table import hashing
from meepoembedding_tpu_torch.table.layout import resolve_device
from meepoembedding_tpu_torch.table.runtime import DynamicEmbeddingTable
from meepoembedding_tpu_torch.tracing import span
from meepoembedding_tpu_torch.weights import from_jax_params


class ScoringService:
    def __init__(self, ckpt_path: str, table_cfg, model_cfg, quantize: str = "none",
                 device="cuda"):
        if quantize not in ("none", "int8"):
            raise ValueError(f"quantize must be none|int8, got {quantize!r}")
        self.table_cfg, self.model_cfg = table_cfg, model_cfg
        self.quantize = quantize
        self._ckpt_path = ckpt_path
        self.device = resolve_device(device)
        self.table, self.manifest = self._load_table(ckpt_path)
        self.model = self._load_model(ckpt_path, self.manifest)
        self._lock = threading.Lock()  # one device; serialize requests
        self._lat_ms: list = []  # ring of recent scoring latencies
        self._requests = 0

    def _load_table(self, path: str):
        """(table, manifest) of a checkpoint: the dynamic table, or with
        quantize="int8" a QuantizedTable after the manifest's dim is
        checked."""
        if self.quantize == "int8":
            manifest = checkpoint.read_manifest(path)
            if manifest["dim"] != self.table_cfg.dim:
                raise ValueError(f"dim mismatch: ckpt {manifest['dim']} vs table config "
                                 f"{self.table_cfg.dim}")
            return QuantizedTable.from_checkpoint(path, device=self.device), manifest
        table = DynamicEmbeddingTable(self.table_cfg, device=self.device)
        return table, table.load(path)

    def _load_model(self, path: str, manifest: dict):
        """The dense tower: the checkpoint's params when it carries them.
        Otherwise a fresh He-init from torch seed 0; the reference draws its
        fallback from jax PRNGKey(0), which torch cannot reproduce."""
        gen = torch.Generator().manual_seed(0)
        model = build_model(self.model_cfg, generator=gen)
        if "params" in manifest.get("dense", []):
            from_jax_params(model, checkpoint.load_dense(path, "params"))
        return model.to(self.device).eval()

    def score(self, dense, ids, lengths=None) -> np.ndarray:
        """[B, ND] f32 + [B, S] or [B, S, L] int64 -> [B] probabilities.
        With bags, `lengths` [B, S] says that their ids are the first
        lengths[b, s] slots of each (`pooling.ragged_batch`)."""
        with span("meepo.serve.request"):
            ids = np.asarray(ids, np.int64)
            ragged = (pooling.takes_ragged(self.model, ids)
                      and hasattr(self.table, "lookup_unique"))
            t0 = time.perf_counter()
            with span("meepo.serve.queue"):
                self._lock.acquire()
            try:
                with torch.no_grad():
                    with span("meepo.serve.inputs"):
                        ids_t = None if ragged else torch.from_numpy(ids).to(self.device)
                        dense_t = torch.from_numpy(np.asarray(dense, np.float32)).to(self.device)
                    bag_valid, shape = None, ids.shape
                    if ragged:
                        rows, shape = self._pooled(ids, lengths)
                    else:
                        rows = self.table.lookup(ids_t.reshape(-1), train=False)
                        if ids.ndim == 3:
                            bag_valid = hashing.is_valid(*hashing.split_ids_t(ids_t))
                    with span("meepo.tower.forward"):
                        emb = model_inputs(self.model, rows, shape, bag_valid,
                                           self.table_cfg.dim, self.model_cfg.combiner)
                        p = torch.sigmoid(model_apply(self.model, dense_t, emb, bag_valid))
                    with span("meepo.serve.readback_sync"):
                        out = p.cpu().numpy()
                self._requests += 1
                self._lat_ms.append((time.perf_counter() - t0) * 1e3)
                if len(self._lat_ms) > 1024:
                    del self._lat_ms[:512]
                return out
            finally:
                self._lock.release()

    def _pooled(self, ids: np.ndarray, lengths):
        """The ragged bags' pooled rows [B * S, dim] and (B, S): the valid
        ids probed once each, pooled by `dedup.GatherRows`."""
        with span("meepo.serve.ragged"):
            flat, bags = pooling.ragged_batch(ids, lengths, self.device,
                                              self.model_cfg.combiner)
        rows, inverse = self.table.lookup_unique(flat)
        pooled = dedup.GatherRows.apply(rows.float(), inverse, None, None, bags)
        return pooled, tuple(bags.lengths.shape)

    def reload(self, ckpt_path: str | None = None) -> dict:
        """Hot-swap to a (usually newer) checkpoint: the replacement table and
        tower are restored off the serving lock, while requests keep being
        answered from the old state, then swapped in at once. Needs room for
        both tables on the device. Raises on a bad checkpoint and leaves the
        old state serving."""
        path = ckpt_path or self._ckpt_path
        table, manifest = self._load_table(path)
        model = self._load_model(path, manifest)
        with self._lock:
            self.table, self.model, self.manifest = table, model, manifest
            self._ckpt_path = path
        return self.stats()

    def metrics_text(self) -> str:
        """Prometheus exposition format: counters and latency quantiles."""
        lines = [
            "# TYPE meepo_table_rows gauge",
            f"meepo_table_rows {len(self.table)}",
            "# TYPE meepo_requests_total counter",
            f"meepo_requests_total {self._requests}",
        ]
        # a QuantizedTable keeps no counters
        for name, v in getattr(self.table, "counters", dict)().items():
            lines.append(f"# TYPE meepo_table_{name}_total counter")
            lines.append(f"meepo_table_{name}_total {v}")
        if self._lat_ms:
            a = np.asarray(self._lat_ms)
            lines.append("# TYPE meepo_score_latency_ms summary")
            for q in (0.5, 0.95, 0.99):
                lines.append(
                    f'meepo_score_latency_ms{{quantile="{q}"}} {float(np.quantile(a, q)):.3f}'
                )
        return "\n".join(lines) + "\n"

    def stats(self) -> dict:
        return {
            "ok": True,
            "rows": len(self.table),
            "step": int(self.manifest.get("step", 0)),
            "dim": self.table_cfg.dim,
        }


def make_http_server(service: ScoringService, port: int,
                     retrieval=None) -> ThreadingHTTPServer:
    """HTTP endpoint on 127.0.0.1:`port` (0 picks a free port). The caller
    runs `serve_forever` and later `shutdown` and `server_close`. With
    `retrieval` (a `RetrievalService` whose index is built), POST /retrieve
    answers the top-k item keys and scores of each query; without it,
    /retrieve is 404."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet: stdout is the service's own log
            pass

        def _reply(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n)) if n else {}

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, service.stats())
            elif self.path == "/metrics":
                body = service.metrics_text().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path == "/reload":
                try:
                    self._reply(200, service.reload(self._body().get("ckpt")))
                except Exception as e:  # the old state keeps serving
                    self._reply(400, {"error": str(e)})
                return
            if self.path == "/retrieve":
                if retrieval is None:
                    self._reply(404, {"error": "retrieval not enabled"})
                    return
                try:
                    req = self._body()
                    dense = np.asarray(req["dense"], np.float32)
                    ids = np.asarray(req["ids"], np.int64)
                    k = int(req.get("k", 10))
                    if dense.ndim != 2 or ids.ndim != 2 or len(dense) != len(ids):
                        raise ValueError(f"dense {dense.shape} / ids {ids.shape} mismatch")
                    keys, scores = retrieval.retrieve(dense, ids, k=k)
                    self._reply(200, {"keys": keys.tolist(),
                                      "scores": np.round(scores, 6).tolist()})
                except Exception as e:  # a malformed request must not stop serving
                    self._reply(400, {"error": str(e)})
                return
            if self.path != "/score":
                self._reply(404, {"error": "unknown path"})
                return
            try:
                req = self._body()
                dense = np.asarray(req["dense"], np.float32)
                ids = np.asarray(req["ids"], np.int64)
                if dense.ndim != 2 or ids.ndim not in (2, 3) or len(dense) != len(ids):
                    raise ValueError(f"dense {dense.shape} / ids {ids.shape} mismatch")
                # pad the batch to the next power of two, as the reference does
                # to bound its compiled shapes; padded rows score and are cut
                b = len(dense)
                bp = 1 << max(0, (b - 1).bit_length())
                if bp != b:
                    dense = np.concatenate(
                        [dense, np.zeros((bp - b,) + dense.shape[1:], np.float32)])
                    pad = np.full((bp - b,) + ids.shape[1:], hashing.EMPTY_ID, np.int64)
                    ids = np.concatenate([ids, pad])
                scores = service.score(dense, ids)[:b]
                self._reply(200, {"scores": np.round(scores, 6).tolist()})
            except Exception as e:  # a malformed request must not stop serving
                self._reply(400, {"error": str(e)})

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)
