"""Host-DRAM KV tier (a copy of `meepoembedding_tpu/backends/host_kv.py`):
a ctypes binding of the repository's `csrc/host_kv.cc` plus a pure-Python
implementation with identical semantics.

The C++ library is compiled at first use with g++ into `build/torch_native/`
at the repository root (git-ignored), named by a hash of the source and the
flags, so the port never loads the JAX package's `_native/libhostkv.so`.
ctypes releases the GIL around every foreign call, so batch lookups run the
C++ thread pool while Python threads (the training loop) keep going.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

_EMPTY = np.int64(-(2**63))
_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_ERR: Optional[str] = None
_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "csrc" / "host_kv.cc"
BUILD_DIR = _ROOT / "build" / "torch_native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-march=native", "-pthread")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libhostkv-{digest.hexdigest()[:16]}.so"


def _build_and_load() -> ctypes.CDLL:
    """Compile csrc/host_kv.cc once (g++) and bind its C interface."""
    global _LIB, _LIB_ERR
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        if _LIB_ERR is not None:
            raise RuntimeError(_LIB_ERR)
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")  # pid-unique: concurrent builds
            try:
                subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
            except (subprocess.SubprocessError, OSError) as e:
                _LIB_ERR = f"host_kv build failed: {e}"
                raise RuntimeError(_LIB_ERR) from e
        lib = ctypes.CDLL(str(so))
        c = ctypes
        lib.hkv_create.restype = c.c_void_p
        lib.hkv_create.argtypes = [c.c_int, c.c_int64]
        lib.hkv_destroy.argtypes = [c.c_void_p]
        lib.hkv_insert.argtypes = [c.c_void_p, c.c_int64, c.c_void_p, c.c_void_p]
        lib.hkv_lookup.restype = c.c_int64
        lib.hkv_lookup.argtypes = [c.c_void_p, c.c_int64, c.c_void_p, c.c_void_p, c.c_void_p]
        lib.hkv_erase.restype = c.c_int64
        lib.hkv_erase.argtypes = [c.c_void_p, c.c_int64, c.c_void_p, c.c_void_p]
        lib.hkv_size.restype = c.c_int64
        lib.hkv_size.argtypes = [c.c_void_p]
        lib.hkv_capacity.restype = c.c_int64
        lib.hkv_capacity.argtypes = [c.c_void_p]
        lib.hkv_export.restype = c.c_int64
        lib.hkv_export.argtypes = [
            c.c_void_p, c.c_int64, c.c_int64, c.c_void_p, c.c_void_p, c.c_void_p,
        ]
        lib.hkv_clear.argtypes = [c.c_void_p]
        _LIB = lib
        return lib


def _as_keys(keys) -> np.ndarray:
    k = np.ascontiguousarray(keys, dtype=np.int64)
    assert k.ndim == 1, f"keys must be [n], got {k.shape}"
    return k


class HostKVStore:
    """C++ host-DRAM store: int64 key -> float32[width] row."""

    def __init__(self, width: int, capacity_hint: int = 1 << 16):
        self._lib = _build_and_load()
        self.width = int(width)
        self._h = self._lib.hkv_create(self.width, int(capacity_hint))
        if not self._h:
            raise MemoryError("hkv_create failed")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.hkv_destroy(h)
            self._h = None

    def insert_batch(self, keys, rows) -> None:
        k = _as_keys(keys)
        r = np.ascontiguousarray(rows, dtype=np.float32)
        assert r.shape == (len(k), self.width), (r.shape, len(k), self.width)
        self._lib.hkv_insert(self._h, len(k), k.ctypes.data, r.ctypes.data)

    def lookup_batch(self, keys) -> Tuple[np.ndarray, np.ndarray]:
        k = _as_keys(keys)
        out = np.empty((len(k), self.width), np.float32)
        found = np.empty(len(k), np.uint8)
        self._lib.hkv_lookup(self._h, len(k), k.ctypes.data, out.ctypes.data, found.ctypes.data)
        return out, found.astype(bool)

    def erase_batch(self, keys) -> np.ndarray:
        k = _as_keys(keys)
        found = np.empty(len(k), np.uint8)
        self._lib.hkv_erase(self._h, len(k), k.ctypes.data, found.ctypes.data)
        return found.astype(bool)

    def export(self, chunk: int = 65536) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        cur = 0
        nxt = np.zeros(1, np.int64)
        keys = np.empty(chunk, np.int64)
        rows = np.empty((chunk, self.width), np.float32)
        while True:
            n = self._lib.hkv_export(
                self._h, cur, chunk, keys.ctypes.data, rows.ctypes.data, nxt.ctypes.data
            )
            if n > 0:
                yield keys[:n].copy(), rows[:n].copy()
            cur = int(nxt[0])
            if cur >= self._lib.hkv_capacity(self._h):
                return

    def clear(self) -> None:
        self._lib.hkv_clear(self._h)

    def __len__(self) -> int:
        return int(self._lib.hkv_size(self._h))


class PyKVStore:
    """Pure-Python dict store with HostKVStore semantics: for machines without
    a C++ toolchain, and the oracle for conformance tests."""

    def __init__(self, width: int, capacity_hint: int = 0):
        self.width = int(width)
        self._d: dict = {}
        self._lock = threading.Lock()

    def insert_batch(self, keys, rows) -> None:
        k = _as_keys(keys)
        r = np.ascontiguousarray(rows, dtype=np.float32)
        assert r.shape == (len(k), self.width)
        with self._lock:
            for i, key in enumerate(k):
                if key != _EMPTY:
                    self._d[int(key)] = r[i].copy()

    def lookup_batch(self, keys) -> Tuple[np.ndarray, np.ndarray]:
        k = _as_keys(keys)
        out = np.zeros((len(k), self.width), np.float32)
        found = np.zeros(len(k), bool)
        with self._lock:
            for i, key in enumerate(k):
                row = self._d.get(int(key))
                if row is not None:
                    out[i] = row
                    found[i] = True
        return out, found

    def erase_batch(self, keys) -> np.ndarray:
        k = _as_keys(keys)
        found = np.zeros(len(k), bool)
        with self._lock:
            for i, key in enumerate(k):
                found[i] = self._d.pop(int(key), None) is not None
        return found

    def export(self, chunk: int = 65536) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        with self._lock:
            items = list(self._d.items())
        for o in range(0, len(items), chunk):
            part = items[o : o + chunk]
            yield (
                np.array([k for k, _ in part], np.int64),
                np.stack([v for _, v in part]) if part else np.zeros((0, self.width), np.float32),
            )

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    def __len__(self) -> int:
        return len(self._d)
