"""Storage-backend tier (a copy of `meepoembedding_tpu/backends/`, host-side
numpy, so that the port never imports the JAX package).

The hot tier is the device-resident table (`table/`); everything behind it
is a `KVBackend`: a host-side store of int64 key -> float32[width] rows used
for cold-row spill and promotion. `width` is dim + metadata columns (the
spill codec packs [value_row, freq, accum, full-dim slots] so backends stay
payload-agnostic).

Registered backends:
  host    C++ open-addressing DRAM store (ctypes, GIL-free batch ops) — C6
  python  pure-Python dict store (fallback/reference semantics)      — C6
  disk    append-log + mmap reads, persistent                        — C8
  redis   remote KV speaking RESP (network tier)                     — C7
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Protocol, Tuple, runtime_checkable

import numpy as np


@runtime_checkable
class KVBackend(Protocol):
    """Uniform KV interface every tier implements."""

    width: int

    def insert_batch(self, keys: np.ndarray, rows: np.ndarray) -> None: ...

    def lookup_batch(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """-> (rows [n, width] float32, found [n] bool); missing rows are 0."""
        ...

    def erase_batch(self, keys: np.ndarray) -> np.ndarray:
        """-> found [n] bool."""
        ...

    def export(self, chunk: int = 65536) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Stream all (keys, rows) in implementation order."""
        ...

    def __len__(self) -> int: ...


_REGISTRY: Dict[str, Callable[..., KVBackend]] = {}


def register_backend(name: str, factory: Callable[..., KVBackend]) -> None:
    """Plug in a new tier."""
    _REGISTRY[name] = factory


def make_backend(name: str, width: int, **kwargs) -> KVBackend:
    if name not in _REGISTRY:
        raise KeyError(f"unknown backend '{name}'; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name](width=width, **kwargs)


def available_backends() -> list:
    return sorted(_REGISTRY)


# --- register built-ins (import side effects kept cheap and failure-proof) ---

from meepoembedding_tpu_torch.backends.host_kv import HostKVStore, PyKVStore  # noqa: E402

register_backend("host", HostKVStore)
register_backend("python", PyKVStore)

from meepoembedding_tpu_torch.backends.disk_kv import DiskKVStore  # noqa: E402

register_backend("disk", DiskKVStore)

from meepoembedding_tpu_torch.backends.remote_kv import RemoteKVStore  # noqa: E402

register_backend("redis", RemoteKVStore)
