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
tower and the sigmoid) in place of some hundred eager launches. So does a
request of fixed-size multi-hot bags ([C, S, L] ids with `lengths`, every
candidate's bags of one length a feature, as MLPerf's `multi_hot_sizes`
makes them): its graph, one a padded size and set of bag lengths, holds the
probe-only unique lookup, the bag pool and the tower, and a padded
candidate's bags hold only the invalid id. Every other request (bags of
differing lengths or without `lengths`, models that pool inside or key items
by their bags, the int8 table, the CPU) runs eagerly, through the same
functions.

Not in the reference: multi-hot bags take the trainer's three paths
(`train.py`, `ops/pooling.py`) from the dynamic table. Pooled ragged bags
(`pooling.takes_ragged`): only the valid ids are probed, and
`dedup.GatherRows` pools the bags from the unique rows. Positional ragged
bags (`pooling.takes_positional`: din or bst given `lengths`): only the
valid ids are probed, and `GatherRows` lays their rows at their places of
the model's zero [C, S, L, dim] input; such a request runs eagerly. Padded
bags: the two-tower, a pooling-inside model given no `lengths`, and the
int8 table, which has no unique-id lookup.
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
    """The size a batch of `c` pads to: the next power of two, at least 1
    (a one-hot request's candidates on the graph path)."""
    return 1 << max(0, (c - 1).bit_length())


def pad_request(dense: np.ndarray, ids: np.ndarray, dense_out: np.ndarray,
                ids_out: np.ndarray, widths: tuple | None = None) -> None:
    """Write a request's [C, ND] dense values and [C, S] (or [C, S, L]) ids
    into the first C rows of [Cp, ...] buffers, and zeros and the invalid id
    into the rest, as `DynamicEmbeddingTable._padded` pads a batch: a padded
    candidate probes to zero rows and its score is cut off. With `widths`,
    the length of every candidate's bag of each feature, a candidate's row
    of `ids_out` [Cp, K] takes its bags' K ids as `pooling.ragged_ids`
    gives them."""
    c = len(ids)
    dense_out[:c] = dense
    dense_out[c:] = 0
    if widths is None:
        ids_out[:c] = ids
    else:
        pooling.fixed_bag_ids(ids, widths, torch.from_numpy(ids_out[:c].reshape(-1)))
    ids_out[c:] = hashing.EMPTY_ID


def fixed_bags(cp: int, widths: tuple, device, combiner: str) -> pooling.Bags:
    """The `Bags` of Cp candidates whose feature s has bags of widths[s]
    ids, the padded candidates' too: a request's of its padded size."""
    lengths = np.repeat(np.asarray(widths, np.int32)[None, :], cp, axis=0)
    return pooling.bags_on(lengths, cp * sum(widths), device, combiner)


def tower_scores(svc, dense_t, rows, shape, ids_t=None, bag_valid=None) -> torch.Tensor:
    """A scoring service's scores of the looked-up rows ([n, dim], the ids
    of `shape` in order): the tower's input, its forward and the sigmoid.
    Bags ([B, S, L] `shape`) take their validity from `bag_valid`, or from
    their padded ids `ids_t`."""
    if bag_valid is None and len(shape) == 3:
        bag_valid = hashing.is_valid(*hashing.split_ids_t(ids_t))
    with span("meepo.tower.forward"):
        emb = model_inputs(svc.model, rows, shape, bag_valid, svc.table_cfg.dim,
                           svc.model_cfg.combiner)
        return torch.sigmoid(model_apply(svc.model, dense_t, emb, bag_valid))


class _RequestGraph:
    """One bucket's captured request: pinned host inputs, their device
    copies, the graph and its [Cp] output (in the service's graph pool).
    One-hot ids are [Cp, S]. Fixed-size bags (`widths`, each feature's bag
    length) are K ids a candidate, bag by bag, in a device buffer that the
    invalid id pads on to the table's power-of-two length, so that the
    lookup adds no padding of its own; their `bags` are built once."""

    def __init__(self, cp: int, num_sparse: int, num_dense: int, device: torch.device,
                 widths: tuple | None = None, combiner: str = "sum"):
        self.shape, self.widths = (cp, num_sparse), widths
        self.bags = None if widths is None else fixed_bags(cp, widths, device, combiner)
        n = cp * (num_sparse if widths is None else sum(widths))
        ids_host = torch.empty((cp, n // cp), dtype=torch.int64, pin_memory=True)
        dense_host = torch.empty((cp, num_dense), dtype=torch.float32, pin_memory=True)
        self.host = (dense_host, ids_host.view(-1))
        self.host_np = (dense_host.numpy(), ids_host.numpy())
        self.dense = torch.empty((cp, num_dense), dtype=torch.float32, device=device)
        self.ids = torch.full((n if widths is None else request_bucket(n),), hashing.EMPTY_ID,
                              dtype=torch.int64, device=device)
        self.graph = torch.cuda.CUDAGraph()
        self.out = None

    def load(self, dense: np.ndarray, ids: np.ndarray) -> None:
        """The request into the device inputs, padded (`pad_request`). The
        pinned buffers are free again: the last request's read-back waited
        for every copy before it."""
        if self.bags is None:
            pad_request(dense, ids, *self.host_np)
        else:
            with span("meepo.serve.ragged"):
                pad_request(dense, ids, *self.host_np, self.widths)
        self.dense.copy_(self.host[0], non_blocking=True)
        self.ids[:self.host[1].shape[0]].copy_(self.host[1], non_blocking=True)


class ScoringService:
    """`graph_replays`, `graph_captures` and `eager_requests` count the
    answered requests by path: a replay of a bucket's graph, the request
    that captured it, or the eager one (bags of differing lengths or without
    `lengths`, models that pool inside or key items by bags, int8, the CPU,
    a bucket whose capture failed). `positional_ids` and
    `positional_padding` count the valid ids of its positional requests and
    the padding slots it kept from the table."""

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
        self.positional_ids = self.positional_padding = 0
        # (bucket, S, ND) of one-hot requests and (bucket, ND, bag lengths)
        # of fixed-size bags -> _RequestGraph, or None where its capture
        # failed; captured on the objects `_graph_of` refers to, in one pool
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
            ragged = hasattr(self.table, "lookup_unique") and (
                pooling.takes_ragged(self.model, ids)
                or pooling.takes_positional(self.model, ids, lengths))
            t0 = time.perf_counter()
            with span("meepo.serve.queue"):
                self._lock.acquire()
            try:
                with torch.no_grad():
                    key = self._graph_key(dense, ids, lengths)
                    out = None if key is None else self._graph_score(key, dense, ids)
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
        bag_valid = None
        if not ragged:
            rows, shape = self.table.lookup(ids_t.reshape(-1), train=False), ids.shape
        elif pooling.takes_positional(self.model, ids, lengths):
            rows, bag_valid = self._positions(ids, lengths)
            shape = ids.shape
        else:
            rows, shape = self._pooled(ids, lengths)
        p = tower_scores(self, dense_t, rows, shape, ids_t, bag_valid)
        with span("meepo.serve.readback_sync"):
            return p.cpu().numpy()

    def _graph_key(self, dense: np.ndarray, ids: np.ndarray, lengths):
        """The key of the graph a request replays, or None for the eager
        way. A graph takes a card, the dynamic table and inputs of one batch
        at the tower's widths, with one-hot ids (key (bucket, S, ND)) or
        pooled bags whose `lengths` hold one length a feature for every
        candidate (key (bucket, ND, the bag lengths)). A malformed request
        goes the eager way, and fails there."""
        mc = self.model_cfg
        if not (self.device.type == "cuda" and isinstance(self.table, DynamicEmbeddingTable)
                and ids.ndim in (2, 3) and dense.ndim == 2 and 0 < len(ids) == len(dense)
                and ids.shape[1] == mc.num_sparse_features
                and dense.shape[1] == mc.num_dense_features):
            return None
        bucket = request_bucket(len(ids))
        if ids.ndim == 2:
            return bucket, ids.shape[1], dense.shape[1]
        # positional bags (a model that pools inside) stay eager: the
        # captured chain pools its bags
        if lengths is None or not pooling.takes_ragged(self.model, ids):
            return None
        if isinstance(lengths, torch.Tensor):
            lengths = lengths.cpu()
        lengths = np.asarray(lengths)
        if lengths.shape != ids.shape[:2] or not (lengths == lengths[0]).all():
            return None
        widths = tuple(int(w) for w in lengths[0])
        if min(widths) < 0 or max(widths) > ids.shape[2] or sum(widths) == 0:
            return None
        return bucket, dense.shape[1], widths

    def _graph_score(self, key: tuple, dense: np.ndarray, ids: np.ndarray):
        """A request's scores from a replay of its bucket's graph, captured
        on the bucket's first request; None where the bucket cannot be
        captured, for the caller to answer eagerly."""
        graphs = self._current_graphs()
        fresh = key not in graphs
        if fresh:
            if ids.ndim == 2:
                graphs[key] = _RequestGraph(*key, self.device)
            else:
                cp, nd, widths = key
                graphs[key] = _RequestGraph(cp, len(widths), nd, self.device, widths,
                                            self.model_cfg.combiner)
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
        """Capture the request's device chain on the loaded inputs of `g`,
        after one eager run on the capture stream, as capture requires.
        False, with the error logged, where the chain cannot be captured."""
        def chain():
            rows = (self.table.lookup(g.ids, train=False) if g.bags is None
                    else self._pool(g.ids, g.bags))
            return tower_scores(self, g.dense, rows, g.shape)

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
        return self._pool(flat, bags), tuple(bags.lengths.shape)

    def _positions(self, ids: np.ndarray, lengths):
        """Positional ragged bags' rows [B * S * L, dim], zero under padding,
        and their validity [B, S, L]: the valid ids probed once each, laid
        out by `dedup.place_rows` (`GatherRows`' forward)."""
        with span("meepo.serve.ragged"):
            flat, pos = pooling.positional_batch(ids, lengths, self.device)
        self.positional_ids += flat.shape[0]
        self.positional_padding += pos.valid.numel() - flat.shape[0]
        rows, inverse = self.table.lookup_unique(flat)
        return dedup.place_rows(rows, inverse, pos), pos.valid

    def _pool(self, flat: torch.Tensor, bags: pooling.Bags) -> torch.Tensor:
        """The pooled rows [B * S, dim] of the bags' ids `flat`, bag by bag
        (the invalid id may follow them), each distinct id probed once."""
        rows, inverse = self.table.lookup_unique(flat)
        return dedup.GatherRows.apply(rows.float(), inverse[:bags.of.shape[0]], None, None,
                                      bags)

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
        for name in ("graph_replays", "graph_captures", "eager_requests", "positional_ids",
                     "positional_padding"):
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
