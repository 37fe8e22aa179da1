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

On a card, a one-hot request ([C, S] ids) to the dynamic table runs as one
captured CUDA graph: C pads to the next power of two (`request_bucket`,
`pad_request`), and each padded size replays its own graph of the whole
device chain (the ids' split, the dedup, the probe, the row gathers, the
tower and the sigmoid) in place of some hundred eager launches. Every other
request (bags, the int8 table, the CPU) runs eagerly, through the same
functions.

Not in the reference: multi-hot bags go the ragged way, as the trainer's
do (`train.py`, `pooling.takes_ragged`), from the dynamic table: only the
valid ids are probed, and `dedup.GatherRows` pools the bags from the unique
rows. The int8 table, which has no unique-id lookup, reads padded bags.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import weakref
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

log = logging.getLogger(__name__)


def request_bucket(c: int) -> int:
    """The candidates a request of `c` pads to on the graph path: the next
    power of two, at least 1."""
    return 1 << max(0, (c - 1).bit_length())


def pad_request(dense: np.ndarray, ids: np.ndarray, dense_out: np.ndarray,
                ids_out: np.ndarray) -> None:
    """Write a request's [C, ND] dense values and [C, S] (or [C, S, L]) ids
    into the first C rows of [Cp, ...] buffers, and zeros and the invalid id
    into the rest, as `DynamicEmbeddingTable._padded` pads a batch: a padded
    candidate probes to zero rows and its score is cut off."""
    c = len(ids)
    dense_out[:c] = dense
    dense_out[c:] = 0
    ids_out[:c] = ids
    ids_out[c:] = hashing.EMPTY_ID


class _RequestGraph:
    """One bucket's captured request: pinned host inputs, their device
    copies, the graph and its [Cp] output (in the service's graph pool)."""

    def __init__(self, cp: int, num_sparse: int, num_dense: int, device: torch.device):
        self.shape = (cp, num_sparse)
        ids_host = torch.empty(self.shape, dtype=torch.int64, pin_memory=True)
        dense_host = torch.empty((cp, num_dense), dtype=torch.float32, pin_memory=True)
        self.host = (dense_host, ids_host.view(-1))
        self.host_np = (dense_host.numpy(), ids_host.numpy())
        self.dense = torch.empty((cp, num_dense), dtype=torch.float32, device=device)
        self.ids = torch.empty((cp * num_sparse,), dtype=torch.int64, device=device)
        self.graph = torch.cuda.CUDAGraph()
        self.out = None

    def load(self, dense: np.ndarray, ids: np.ndarray) -> None:
        """The request into the device inputs, padded (`pad_request`). The
        pinned buffers are free again: the last request's read-back waited
        for every copy before it."""
        pad_request(dense, ids, *self.host_np)
        self.dense.copy_(self.host[0], non_blocking=True)
        self.ids.copy_(self.host[1], non_blocking=True)


class ScoringService:
    """`graph_replays`, `graph_captures` and `eager_requests` count the
    answered requests by path: a replay of a bucket's graph, the request
    that captured it, or the eager one (bags, int8, the CPU, a bucket whose
    capture failed)."""

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
        self.graph_replays = self.graph_captures = self.eager_requests = 0
        # (bucket, S, ND) -> _RequestGraph, or None where its capture failed;
        # captured on the objects `_graph_of` refers to, in one pool
        self._graphs: dict = {}
        self._graph_of = self._graph_pool = None

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
            dense = np.asarray(dense, np.float32)
            ragged = (pooling.takes_ragged(self.model, ids)
                      and hasattr(self.table, "lookup_unique"))
            t0 = time.perf_counter()
            with span("meepo.serve.queue"):
                self._lock.acquire()
            try:
                with torch.no_grad():
                    out = self._graph_score(dense, ids) if self._takes_graph(dense, ids) else None
                    if out is None:
                        out = self._eager_score(dense, ids, lengths, ragged)
                        self.eager_requests += 1
                self._requests += 1
                self._lat_ms.append((time.perf_counter() - t0) * 1e3)
                if len(self._lat_ms) > 1024:
                    del self._lat_ms[:512]
                return out
            finally:
                self._lock.release()

    def _eager_score(self, dense: np.ndarray, ids: np.ndarray, lengths,
                     ragged: bool) -> np.ndarray:
        """A request's scores, one eager launch at a time."""
        with span("meepo.serve.inputs"):
            ids_t = None if ragged else torch.from_numpy(ids).to(self.device)
            dense_t = torch.from_numpy(dense).to(self.device)
        bag_valid, shape = None, ids.shape
        if ragged:
            rows, shape = self._pooled(ids, lengths)
        else:
            rows = self.table.lookup(ids_t.reshape(-1), train=False)
            if ids.ndim == 3:
                bag_valid = hashing.is_valid(*hashing.split_ids_t(ids_t))
        p = self._forward(dense_t, rows, shape, bag_valid)
        with span("meepo.serve.readback_sync"):
            return p.cpu().numpy()

    def _forward(self, dense_t, rows, shape, bag_valid=None) -> torch.Tensor:
        """The tower's scores of the looked-up rows: its input, its forward
        and the sigmoid."""
        with span("meepo.tower.forward"):
            emb = model_inputs(self.model, rows, shape, bag_valid, self.table_cfg.dim,
                               self.model_cfg.combiner)
            return torch.sigmoid(model_apply(self.model, dense_t, emb, bag_valid))

    def _takes_graph(self, dense: np.ndarray, ids: np.ndarray) -> bool:
        """Whether a request runs as its bucket's graph: one-hot ids, the
        dynamic table, a card, and inputs of one batch at the tower's
        widths. A malformed request goes the eager way, and fails there."""
        mc = self.model_cfg
        return (self.device.type == "cuda" and isinstance(self.table, DynamicEmbeddingTable)
                and ids.ndim == 2 and dense.ndim == 2 and 0 < len(ids) == len(dense)
                and ids.shape[1] == mc.num_sparse_features
                and dense.shape[1] == mc.num_dense_features)

    def _graph_score(self, dense: np.ndarray, ids: np.ndarray):
        """A one-hot request's scores from a replay of its bucket's graph,
        captured on the bucket's first request; None where the bucket cannot
        be captured, for the caller to answer eagerly."""
        key = (request_bucket(len(ids)), ids.shape[1], dense.shape[1])
        graphs = self._current_graphs()
        fresh = key not in graphs
        if fresh:
            graphs[key] = _RequestGraph(*key, self.device)
        g = graphs[key]
        if g is None:
            return None
        with span("meepo.serve.graph"):
            g.load(dense, ids)
            if fresh and not self._capture(g):
                graphs[key] = None
                return None
            g.graph.replay()
        with span("meepo.serve.readback_sync"):
            out = g.out[:len(ids)].cpu().numpy()
        if fresh:
            self.graph_captures += 1
        else:
            self.graph_replays += 1
        return out

    def _current_graphs(self) -> dict:
        """The graphs of the table, shard and tower served now. A graph holds
        their planes' and weights' addresses, so where `reload`, the table's
        `load` or its growth replaced any of them, the old graphs go and the
        next requests capture anew."""
        live = (self.table, self.table.shard, self.model)
        if self._graph_of is None or any(r() is not o for r, o in zip(self._graph_of, live)):
            self._graphs, self._graph_pool = {}, torch.cuda.graph_pool_handle()
            self._graph_of = tuple(weakref.ref(o) for o in live)
        return self._graphs

    def _capture(self, g: _RequestGraph) -> bool:
        """Capture the one-hot request's device chain on the loaded inputs of
        `g`, after one eager run on the capture stream, as capture requires.
        False, with the error logged, where the chain cannot be captured."""
        def chain():
            return self._forward(g.dense, self.table.lookup(g.ids, train=False), g.shape)

        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        try:
            # the outer context gives the current stream back where the
            # capture fails, which `torch.cuda.graph` alone does not
            with torch.cuda.stream(stream):
                chain()
                with torch.cuda.graph(g.graph, pool=self._graph_pool, stream=stream,
                                      capture_error_mode="thread_local"):
                    g.out = chain()
        except Exception:  # a forward that cannot be captured still answers, eagerly
            log.exception("scoring: the request of %d candidates cannot be captured as a "
                          "CUDA graph; its bucket runs eagerly", g.shape[0])
            # a failed capture may leave its stream allocating from its pool:
            # later captures take a new pool
            self._graph_pool = torch.cuda.graph_pool_handle()
            torch.cuda.current_stream(self.device).wait_stream(stream)
            return False
        return True

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
        for name in ("graph_replays", "graph_captures", "eager_requests"):
            lines.append(f"# TYPE meepo_{name}_total counter")
            lines.append(f"meepo_{name}_total {getattr(self, name)}")
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
                scores = service.score(dense, ids)
                self._reply(200, {"scores": np.round(scores, 6).tolist()})
            except Exception as e:  # a malformed request must not stop serving
                self._reply(400, {"error": str(e)})

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)
