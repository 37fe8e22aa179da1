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

`LockstepFront` serves S > 1 ranks from one HTTP server: on rank 0 it has
the single-device surface over global batches, which it splits over the
ranks as the reference's one-process service does; the other ranks follow
it, op by op.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import queue
import signal
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from meepoembedding_tpu_torch import checkpoint
from meepoembedding_tpu_torch.models import build_model
from meepoembedding_tpu_torch.ops import dedup
from meepoembedding_tpu_torch.parallel import sharded_table as st
from meepoembedding_tpu_torch.parallel.mesh import Mesh, make_mesh
from meepoembedding_tpu_torch.parallel.trainer import SHARDED_COUNTER_NAMES, sum_ints
from meepoembedding_tpu_torch.serving import request_bucket, tower_scores
from meepoembedding_tpu_torch.table import hashing
from meepoembedding_tpu_torch.table.layout import TableSpec
from meepoembedding_tpu_torch.weights import from_jax_params


class ShardedScoringService:
    """Row-sharded, probe-only scoring over a mesh (default: the world on
    `device`). A reload is two-phase: `load_state(path)` restores off the
    serving state and makes no collective, `install_state(path, state)`
    swaps the result in; `reload` runs both, `LockstepFront` agrees over
    the ranks between them."""

    def __init__(self, ckpt_path: str, table_cfg, model_cfg, mesh: Optional[Mesh] = None,
                 a2a_factor: float = 1.25, device="cuda"):
        self.mesh = mesh or make_mesh(device=device)
        self.S, self.device = self.mesh.size, self.mesh.device
        self.table_cfg, self.model_cfg = table_cfg, model_cfg
        self.a2a_factor = a2a_factor
        self.ckpt_path = ckpt_path
        self._lock = threading.Lock()  # one exchange at a time
        self._lat_ms: list = []
        self._requests = 0
        self.route_drops = 0  # lifetime: ids scored with zero rows
        self.install_state(ckpt_path, self.load_state(ckpt_path))

    def load_state(self, path: str):
        """(table config, spec, this rank's shard, tower, manifest) of a
        checkpoint: its rows rehashed to their owners at this S. A growable
        table config first grows to fit the saved rows; a fixed one that
        cannot hold them raises. No collective, and nothing of the service
        changes: `install_state` swaps the result in, so a reload keeps
        serving the old state until the new one is up."""
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
        # without saved params, a He-init from torch seed 0 (as ScoringService)
        model = build_model(self.model_cfg, generator=torch.Generator().manual_seed(0))
        if "params" in manifest.get("dense", []):
            from_jax_params(model, checkpoint.load_dense(path, "params"))
        return cfg, spec, shards[self.mesh.rank], model.to(self.device).eval(), manifest

    def install_state(self, path: str, state) -> None:
        """Swap in a `load_state` result at once."""
        with self._lock:
            self.table_cfg, self.spec, self.shard, self.model, self.manifest = state
            self.ckpt_path = path

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
            bp = request_bucket(b)
            if bp != b:
                dense = np.concatenate([dense, np.zeros((bp - b,) + dense.shape[1:], np.float32)])
                ids = np.concatenate(
                    [ids, np.full((bp - b,) + ids.shape[1:], hashing.EMPTY_ID, np.int64)])
            rows, drops = self._exchange(ids.reshape(-1))
            dense_t = torch.from_numpy(dense).to(self.device)
            ids_t = torch.from_numpy(ids).to(self.device) if ids.ndim == 3 else None
            out = tower_scores(self, dense_t, rows, ids.shape, ids_t).cpu().numpy()
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
        ids_p = np.full((request_bucket(n),), hashing.EMPTY_ID, np.int64)
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
        path = ckpt_path or self.ckpt_path
        self.install_state(path, self.load_state(path))
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


# --- one HTTP front over S ranks --------------------------------------------------

_NOOP, _STOP, _SCORE, _LOOKUP, _RELOAD, _STATS, _METRICS, _COUNTERS = range(8)
_HEADER = 8  # int64 words: op, then the op's sizes (see LockstepFront._header)
_POLL_S = 0.2  # how often rank 0's idle loop looks at its stop flag
_HEARTBEAT_S = 30.0  # rank 0 idle this long sends a no-op (see LockstepFront)
# ids one rank takes from one request (rows a rank times ids a row): a
# bigger request is refused on rank 0 before any rank hears of it, since a
# failure after the broadcast (a rank out of memory) ends every rank
MAX_RANK_IDS = 1 << 22


class ReloadRefused(ValueError):
    """A reload that some rank could not restore: every rank keeps serving
    its old state."""


def _split(b: int, S: int) -> int:
    """Rows a rank of a global batch of b: next_pow2(ceil(b / S)), as the
    reference's `_pad_batch`; the batch pads to that times S."""
    return request_bucket(-(-b // S))


class LockstepFront:
    """One HTTP front over the S ranks of a per-rank service
    (`ShardedScoringService`, or `GroupScoringService(distributed=True)`)
    on `mesh`.

    Every method of the per-rank service is a collective, so all ranks must
    run the same ops in the same order, from one thread each. On rank 0 the
    front has the single-device surface: `score(dense, ids)` of a global
    batch, `table.lookup(ids)` of global ids, `reload`, `stats`,
    `metrics_text`, `counters`, `model`, `table_cfg` and `device`, so
    `serving.make_http_server(front, port, retrieval=RetrievalService(front))`
    serves it. A request pads to S * per rows (`_split`) with zero dense
    rows and `hashing.EMPTY_ID`, rank r scores rows [r * per, (r + 1) *
    per) through its own service, and rank 0 gathers the replies in rank
    order and cuts them to B: the per-rank exchange sees the reference's
    shapes and capacities. `run(server)` serves on rank 0: the server's
    handler threads queue their calls for this thread, which broadcasts
    each op (a fixed header, then its payload, as CPU tensors: gloo) and
    runs its part; `follow()` runs the other ranks' parts until the stop
    op. Calls from the thread that made the front run at once.

    A request is checked on rank 0 before anything is broadcast, so a
    malformed or oversized one (more than `MAX_RANK_IDS` ids a rank)
    raises there (a 400) and the ranks stay in step. A reload restores on
    every rank (`load_state`), then all agree (MIN of an ok flag) to swap
    in the new state (`install_state`) or to keep the old one
    (`ReloadRefused`). Any other failure inside an op ends the front with
    the error and sends no stop op, since the ranks may wait in different
    collectives: the failed rank exits, and the process group ends the
    others. SIGINT or SIGTERM on rank 0 (or `stop()`) sends the stop op;
    every rank returns 0. Rank 0 sends a no-op after `_HEARTBEAT_S` idle
    seconds, so that a follower's wait stays inside the process group's
    timeout, which ends a world whose rank 0 died."""

    def __init__(self, service, mesh: Mesh):
        self.svc, self.mesh = service, mesh
        self.S, self.rank = mesh.size, mesh.rank
        self._src = 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)
        self._owner = threading.current_thread()
        self._q: queue.Queue = queue.Queue()
        self._stop_flag = threading.Event()
        self._looping = self._stopped = False
        self._ops = {_SCORE: self._op_score, _LOOKUP: self._op_lookup,
                     _RELOAD: self._op_reload, _STATS: lambda h: self.svc.stats(),
                     _METRICS: lambda h: self.svc.metrics_text(),
                     _COUNTERS: lambda h: self.svc.counters()}

    # --- the single-device surface (rank 0) ----------------------------------------
    @property
    def model(self):
        return self.svc.model

    @property
    def table_cfg(self):
        return self.svc.table_cfg

    @property
    def device(self):
        return self.svc.device

    @property
    def table(self):
        """`RetrievalService` reads rows through `scoring.table.lookup`."""
        return self

    def score(self, dense, ids) -> np.ndarray:
        """[B, ND] f32 + [B, F] or [B, F, L] int64 -> [B] probabilities
        over the ranks. Raises ValueError, before any rank hears of it, on
        a batch of the wrong shape or too large a one."""
        dense = np.ascontiguousarray(dense, np.float32)
        ids = np.ascontiguousarray(ids, np.int64)
        nd = self.svc.model_cfg.num_dense_features
        nf = getattr(self.svc, "num_features", self.svc.model_cfg.num_sparse_features)
        if (dense.ndim != 2 or ids.ndim not in (2, 3) or len(dense) != len(ids)
                or not len(dense) or dense.shape[1] != nd or ids.shape[1] != nf):
            raise ValueError(f"dense {dense.shape} / ids {ids.shape}: want [B, {nd}] and "
                             f"[B, {nf}] or [B, {nf}, L], B > 0")
        self._check_size(len(ids), ids[0].size)
        return self._call(_SCORE, dense, ids)

    def lookup(self, ids64, train: bool = False) -> torch.Tensor:
        """[n] int64 -> [n, dim] f32 rows on rank 0's device; absent ids
        give zero rows."""
        if train:
            raise ValueError("sharded serving is probe-only")
        if not hasattr(self.svc, "lookup"):
            raise ValueError(f"{type(self.svc).__name__} has no row lookup")
        ids = np.ascontiguousarray(ids64, np.int64).reshape(-1)
        if not len(ids):
            raise ValueError("no ids to look up")
        self._check_size(len(ids), 1)
        return self._call(_LOOKUP, ids)

    def reload(self, ckpt_path: Optional[str] = None) -> dict:
        """Every rank restores the checkpoint, then all swap to it, or, if
        any rank failed, all keep the old one and this raises
        `ReloadRefused`."""
        if ckpt_path is not None and not isinstance(ckpt_path, str):
            raise ValueError(f"ckpt must be a path, got {ckpt_path!r}")
        return self._call(_RELOAD, ckpt_path or "")

    def stats(self) -> dict:
        return self._call(_STATS)

    def metrics_text(self) -> str:
        return self._call(_METRICS)

    def counters(self) -> dict:
        if not hasattr(self.svc, "counters"):
            raise ValueError(f"{type(self.svc).__name__} has no counters")
        return self._call(_COUNTERS)

    def _check_size(self, b: int, per_row: int) -> None:
        n = _split(b, self.S) * per_row
        if n > MAX_RANK_IDS:
            raise ValueError(f"{b} rows of {per_row} ids give a rank {n} ids, more than the "
                             f"{MAX_RANK_IDS} a request may; split the request")

    # --- serving and following ----------------------------------------------------------
    def run(self, server=None) -> int:
        """Rank 0: serve `server` (a `make_http_server` over this front) on
        a thread of its own and run the ops its handlers queue, until
        SIGINT, SIGTERM or `stop()`; then send the stop op. Other ranks:
        `follow()`. Returns 0."""
        if self.rank != 0:
            return self.follow()
        th = None
        if server is not None:
            th = threading.Thread(target=server.serve_forever, daemon=True)
            th.start()
        trapped = self._trap((signal.SIGINT, signal.SIGTERM), lambda *_: self._stop_flag.set())
        self._looping = True
        try:
            idle = time.monotonic()
            while not self._stop_flag.is_set():
                try:
                    op, payload, fut = self._q.get(timeout=_POLL_S)
                except queue.Empty:
                    if time.monotonic() - idle > _HEARTBEAT_S:
                        self._bcast(self._header(_NOOP))
                        idle = time.monotonic()
                    continue
                self._serve_one(op, payload, fut)
                idle = time.monotonic()
            self._finish()
        finally:
            self._looping = False
            self._untrap(trapped)
            while not self._q.empty():
                self._q.get_nowait()[2].set_exception(RuntimeError("the front has stopped"))
            if server is not None:
                server.shutdown()
                server.server_close()
                th.join(timeout=30)
        return 0

    def follow(self) -> int:
        """Ranks > 0: run each op rank 0 sends, until the stop op; returns
        0. SIGINT is ignored meanwhile: rank 0 decides when the world
        stops."""
        if self.rank == 0:
            raise RuntimeError("rank 0 serves (run); the other ranks follow")
        trapped = self._trap((signal.SIGINT,), signal.SIG_IGN)
        try:
            while True:
                hdr = self._header(_NOOP)
                self._bcast(hdr)
                op = int(hdr[0])
                if op == _STOP:
                    return 0
                if op != _NOOP:
                    try:
                        self._ops[op](hdr)
                    except ReloadRefused:
                        pass
        finally:
            self._untrap(trapped)

    def stop(self) -> None:
        """Rank 0, from any thread: end `run` (the stop op). From the thread
        that made the front, outside `run`, the stop op goes at once."""
        if threading.current_thread() is self._owner and not self._looping:
            self._finish()
        else:
            self._stop_flag.set()

    # --- the ops ----------------------------------------------------------------------
    def _call(self, op: int, *payload):
        if self.rank != 0:
            raise RuntimeError("requests go to rank 0; the other ranks follow()")
        if self._stopped:
            raise RuntimeError("the front has stopped")
        if threading.current_thread() is self._owner and not self._looping:
            return self._lead(op, payload)
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._q.put((op, payload, fut))
        return fut.result()

    def _serve_one(self, op: int, payload, fut) -> None:
        try:
            fut.set_result(self._lead(op, payload))
        except BaseException as e:
            fut.set_exception(e)
            if not isinstance(e, ReloadRefused):  # refused: the ranks agreed, in step
                raise

    def _lead(self, op: int, payload):
        """Rank 0's side of an op: its header to every rank, then its part."""
        hdr = self._header(op, *payload)
        self._bcast(hdr)
        try:
            return self._ops[op](hdr, *payload)
        except ReloadRefused:
            raise
        except BaseException:  # the ranks may wait in different collectives:
            self._stopped = True  # no stop op can reach them
            raise

    def _finish(self) -> None:
        if not self._stopped:
            self._stopped = True
            self._bcast(self._header(_STOP))

    def _header(self, op: int, *payload) -> torch.Tensor:
        """[op, B, per, ids ndim, F, L, ND, 0] a score; [op, n, per, ...] a
        lookup; [op, path bytes, ...] a reload."""
        h = [op] + [0] * (_HEADER - 1)
        if op == _SCORE:
            dense, ids = payload
            b = len(dense)
            h[1:7] = [b, _split(b, self.S), ids.ndim, ids.shape[1],
                      ids.shape[2] if ids.ndim == 3 else 0, dense.shape[1]]
        elif op == _LOOKUP:
            h[1:3] = [len(payload[0]), _split(len(payload[0]), self.S)]
        elif op == _RELOAD:
            h[1] = len(payload[0].encode())
        return torch.tensor(h, dtype=torch.int64)

    def _op_score(self, hdr, dense=None, ids=None):
        b, per, ndim, f, bag, nd = (int(x) for x in hdr[1:7])
        shape = (per, f) + ((bag,) if ndim == 3 else ())
        d = self._scatter(torch.empty((per, nd), dtype=torch.float32), dense, 0.0)
        i = self._scatter(torch.empty(shape, dtype=torch.int64), ids, hashing.EMPTY_ID)
        p = torch.from_numpy(np.ascontiguousarray(self.svc.score(d.numpy(), i.numpy()),
                                                  np.float32))
        parts = self._gather(p)
        return None if parts is None else torch.cat(parts).numpy()[:b]

    def _op_lookup(self, hdr, ids=None):
        n, per = int(hdr[1]), int(hdr[2])
        i = self._scatter(torch.empty((per,), dtype=torch.int64), ids, hashing.EMPTY_ID)
        rows = self.svc.lookup(i.numpy()).to(device="cpu", dtype=torch.float32).contiguous()
        parts = self._gather(rows)
        return None if parts is None else torch.cat(parts)[:n].to(self.svc.device)

    def _op_reload(self, hdr, path=None):
        buf = torch.zeros((int(hdr[1]),), dtype=torch.uint8)
        if path:
            buf.copy_(torch.frombuffer(bytearray(path.encode()), dtype=torch.uint8))
        if buf.numel():
            self._bcast(buf)
        path = bytes(buf.numpy()).decode() or self.svc.ckpt_path
        state, err = None, None
        try:  # off the serving state: nothing changes until every rank is ready
            state = self.svc.load_state(path)
        except Exception as e:  # any failure keeps the old state on every rank
            err = f"{type(e).__name__}: {e}"
            print(f"rank {self.rank}: reload of {path} failed: {err}", file=sys.stderr)
        ok = torch.tensor([state is not None], dtype=torch.int32)
        dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=self.mesh.group)
        if not int(ok):
            raise ReloadRefused(err or "another rank could not restore the checkpoint; the "
                                "old one keeps serving")
        self.svc.install_state(path, state)
        return self.svc.stats()

    # --- transport: CPU tensors on the mesh's group (gloo) ------------------------------
    def _bcast(self, t: torch.Tensor) -> None:
        dist.broadcast(t, src=self._src, group=self.mesh.group)

    def _scatter(self, out: torch.Tensor, full: Optional[np.ndarray], fill) -> torch.Tensor:
        """Rank r's rows [r * per, (r + 1) * per) of rank 0's `full`, padded
        with `fill` to S * per rows."""
        parts = None
        if self.rank == 0:
            per = out.shape[0]
            padded = torch.full((self.S * per,) + tuple(out.shape[1:]), fill, dtype=out.dtype)
            padded[:len(full)] = torch.from_numpy(full)
            parts = list(padded.split(per))
        dist.scatter(out, parts, src=self._src, group=self.mesh.group)
        return out

    def _gather(self, t: torch.Tensor):
        """Every rank's `t` in rank order on rank 0 (None elsewhere)."""
        parts = [torch.empty_like(t) for _ in range(self.S)] if self.rank == 0 else None
        dist.gather(t, parts, dst=self._src, group=self.mesh.group)
        return parts

    @staticmethod
    def _trap(signals, handler):
        """Install `handler` for `signals` (main thread only); the previous
        handlers, for `_untrap`."""
        if threading.current_thread() is not threading.main_thread():
            return {}
        return {s: signal.signal(s, handler) for s in signals}

    @staticmethod
    def _untrap(trapped) -> None:
        for s, h in trapped.items():
            signal.signal(s, h)
