"""Background batch prefetch (a copy of `meepoembedding_tpu/data/prefetch.py`):
a daemon thread runs the inner stream's generator and keeps a small bounded
queue of ready batches, so host-side parsing and generation overlap the
training step. The native Criteo parser releases the GIL, so on that path
the overlap is real parallelism. Host-only: batches stay numpy arrays.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional


class PrefetchStream:
    """Wraps any object with .batches(steps) -> iterator of batch dicts;
    keeps the batch order, raises the worker's exception in the consumer,
    and forwards other attributes (`parser`, `paths`, ...) to the inner
    stream."""

    _END = object()

    def __init__(self, inner, depth: int = 2):
        self.inner = inner
        self.depth = depth

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def batches(self, steps: Optional[int] = None) -> Iterator[dict]:
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        err: list = []
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put that gives up once the consumer has abandoned the
            # generator, so the worker never blocks forever on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for b in self.inner.batches(steps):
                    if not put(b):
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
                err.append(e)
            finally:
                put(self._END)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                b = q.get()
                if b is self._END:
                    if err:
                        raise err[0]
                    return
                yield b
        finally:
            stop.set()  # also on GeneratorExit or an exception in the consumer
