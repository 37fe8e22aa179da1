"""Hot/cold tiering (port of `meepoembedding_tpu/tiering.py`): eviction
spill and promotion between the device table and a `KVBackend` cold tier.

  SpillCodec      packs a row's full training state (value row, hit count,
                  rowwise accumulator, full-dim optimizer slots) into one
                  float32[width] backend payload, so every tier stays a dumb
                  (key -> flat row) store.
  spill_export    an `EvictExport` (from `table_ops.evict_pass`) -> backend
                  inserts.
  PromotionEngine async promotion: probe misses go to a host worker thread
                  that looks them up in the cold tier; hits are re-inserted
                  into the device table (with their optimizer state) just
                  before a later lookup, so a step never waits on host or
                  network I/O for them.

The device hands the host its tensors as synchronous copies: the export's
rows and the misses fed to the promoter are host arrays before the call
that takes them returns, so later in-place steps cannot reach them.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from meepoembedding_tpu_torch.table import hashing
from meepoembedding_tpu_torch.table.layout import TableSpec
from meepoembedding_tpu_torch.table.table_ops import EvictExport


def _host(x) -> np.ndarray:
    """A host numpy array of `x`; a tensor is copied to the host (and bf16
    widened to f32, exactly)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return np.asarray(x)


class SpillCodec:
    """Row payload layout: [values(dim) | freq(1) | accum(R) | fulldim(F*dim)]."""

    def __init__(self, spec: TableSpec):
        self.spec = spec
        self.n_row = spec.optimizer.num_rowwise_slots()
        self.n_full = spec.optimizer.num_fulldim_slots()
        self.width = spec.dim * (1 + self.n_full) + 1 + self.n_row

    def pack(self, rows, freq, accum=None, fulldim=()) -> np.ndarray:
        n = rows.shape[0]
        parts = [np.asarray(rows, np.float32), np.asarray(freq, np.float32)[:, None]]
        if self.n_row:
            a = accum if accum is not None else np.full(
                (n,), self.spec.optimizer.initial_accumulator, np.float32
            )
            parts.append(np.asarray(a, np.float32)[:, None])
        for j in range(self.n_full):
            f = fulldim[j] if j < len(fulldim) else np.zeros((n, self.spec.dim), np.float32)
            parts.append(np.asarray(f, np.float32))
        return np.concatenate(parts, axis=1)

    def unpack(self, payload: np.ndarray) -> dict:
        d = self.spec.dim
        out = {"values": payload[:, :d], "freq": payload[:, d].astype(np.int32)}
        o = d + 1
        if self.n_row:
            out["accum"] = payload[:, o]
            o += 1
        out["fulldim"] = tuple(
            payload[:, o + j * d : o + (j + 1) * d] for j in range(self.n_full)
        )
        return out


def spill_export(codec: SpillCodec, backend, export: EvictExport) -> int:
    """Drain one shard's EvictExport into the cold tier (its first `count`
    rows, copied to the host). Returns rows spilled."""
    n = int(export.count)
    if n == 0 or backend is None:
        return 0
    keys = hashing.join_ids(_host(export.hi[:n]), _host(export.lo[:n]))
    payload = codec.pack(
        _host(export.rows[:n]),
        _host(export.freq[:n]),
        _host(export.accum[:n]) if codec.n_row else None,
        tuple(_host(f[:n]) for f in export.fulldim),
    )
    backend.insert_batch(keys, payload)
    return n


class PromotionEngine:
    """Async cold->hot promotion.

    `feed(hi, lo, missed)` takes a lookup's unique keys and miss mask
    (copied to the host here, before it returns); a worker thread queries
    the cold tier and stages the hits. `drain()` returns the staged rows for
    re-insertion into the device table (the caller runs the insert) and
    erases them from the cold tier. One-lookup lag by design: a missed id
    trains from its fresh init until its spilled state overwrites it."""

    def __init__(self, codec: SpillCodec, backend, max_queue: int = 8):
        self.codec = codec
        self.backend = backend
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._staged_lock = threading.Lock()
        self._staged: list = []
        self._pending = 0  # fed batches not yet fully processed
        self.staged = 0  # lifetime: rows drained toward the hot tier
        self.respilled = 0  # lifetime: staged rows returned to the cold tier
        self._stop = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def feed(self, hi, lo, missed) -> None:
        """Non-blocking for the worker; drops the batch if the queue is full
        (misses are observed again the next time the id appears, so drops
        only delay)."""
        item = (_host(hi), _host(lo), _host(missed))
        with self._staged_lock:
            self._pending += 1
        try:
            self._q.put_nowait(item)
        except queue.Full:
            with self._staged_lock:
                self._pending -= 1

    def _run(self):
        while not self._stop:
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is None:
                return
            hi, lo, m = item
            try:
                if m.any():
                    keys = hashing.join_ids(hi[m], lo[m])
                    payload, found = self.backend.lookup_batch(keys)
                    if found.any():
                        with self._staged_lock:
                            self._staged.append((keys[found], payload[found]))
            except Exception:  # backend hiccups must never kill training
                pass
            finally:
                with self._staged_lock:
                    self._pending -= 1

    def drain(self) -> Optional[Tuple[np.ndarray, dict]]:
        """-> (keys, unpacked state) of all staged promotions, or None."""
        with self._staged_lock:
            staged, self._staged = self._staged, []
        if not staged:
            return None
        keys = np.concatenate([k for k, _ in staged])
        payload = np.concatenate([p for _, p in staged])
        # last write wins on duplicates: unique keeps the first occurrence,
        # so reverse the feed order first
        keys_rev, payload_rev = keys[::-1], payload[::-1]
        keys, idx = np.unique(keys_rev, return_index=True)
        payload = payload_rev[idx]
        self.backend.erase_batch(keys)
        self.staged += len(keys)
        return keys, self.codec.unpack(payload)

    @property
    def promoted(self) -> int:
        """Rows that landed in the hot tier: staged minus the slot-race
        losers the caller re-spilled (`respill_failed`)."""
        return self.staged - self.respilled

    def flush(self, timeout: float = 5.0) -> None:
        """Block until every fed batch is fully processed (tests, shutdown)."""
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            with self._staged_lock:
                if self._pending == 0:
                    return
            time.sleep(0.01)

    def close(self):
        self._stop = True
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass


def respill_failed(promoter: PromotionEngine, keys, state, ok) -> int:
    """Return staged rows whose hot-tier insert failed (a slot race on a
    full table) to the cold tier with their full payload, so trained state
    is never lost between tiers. `ok` is the insert's success mask aligned
    with `keys`. Returns the re-spilled count and adds it to
    `promoter.respilled`."""
    keys = np.asarray(keys)
    fail = ~_host(ok)[: len(keys)].astype(bool)
    n = int(fail.sum())
    if n == 0 or promoter.backend is None:
        return 0
    payload = promoter.codec.pack(
        np.asarray(state["values"])[fail],
        np.asarray(state["freq"])[fail],
        np.asarray(state["accum"])[fail] if "accum" in state else None,
        tuple(np.asarray(f)[fail] for f in state["fulldim"]),
    )
    promoter.backend.insert_batch(keys[fail], payload)
    promoter.respilled += n
    return n
