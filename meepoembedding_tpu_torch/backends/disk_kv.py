"""SSD/disk KV tier (a copy of `meepoembedding_tpu/backends/disk_kv.py`):
append-log + in-memory index, mmap reads, for capacities beyond DRAM.

Records append to a log file; an in-memory dict maps key -> latest file
offset (last write wins); reads go through one shared mmap so lookups are
page-cache-speed without loading the log. `compact()` rewrites only live
records (reclaims space after overwrites/erases).
"""

from __future__ import annotations

import mmap
import os
import struct
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

_EMPTY = np.int64(-(2**63))
_MAGIC = b"MPKV0001"


class DiskKVStore:
    """Append-log disk store: int64 key -> float32[width]."""

    def __init__(self, width: int, path: str, capacity_hint: int = 0):
        self.width = int(width)
        self.path = path
        self._rec = 8 + 4 * self.width  # key + row, fixed size
        self._lock = threading.Lock()
        self._index: dict = {}
        self._mm: Optional[mmap.mmap] = None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if os.path.exists(path) and os.path.getsize(path) >= len(_MAGIC) + 4:
            self._open_existing()
        else:
            with open(path, "wb") as f:
                f.write(_MAGIC + struct.pack("<i", self.width))
        self._f = open(path, "r+b")
        self._f.seek(0, os.SEEK_END)

    def _open_existing(self):
        with open(self.path, "rb") as f:
            head = f.read(len(_MAGIC) + 4)
            assert head[: len(_MAGIC)] == _MAGIC, f"{self.path}: not a DiskKVStore log"
            (w,) = struct.unpack("<i", head[len(_MAGIC) :])
            assert w == self.width, f"{self.path}: width {w} != {self.width}"
            off = len(head)
            data = f.read()
        pos = 0
        n_full = len(data) // self._rec
        for i in range(n_full):
            key = struct.unpack_from("<q", data, pos)[0]
            if key == _EMPTY:  # erase marker: INT64_MIN is never a user key
                real = struct.unpack_from("<q", data, pos + 8)[0]
                self._index.pop(real, None)
            else:
                self._index[key] = off + pos + 8
            pos += self._rec

    def _remap(self):
        if self._mm is not None:
            self._mm.close()
        self._f.flush()
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)

    def insert_batch(self, keys, rows) -> None:
        k = np.ascontiguousarray(keys, dtype=np.int64)
        r = np.ascontiguousarray(rows, dtype=np.float32)
        assert r.shape == (len(k), self.width)
        with self._lock:
            base = self._f.tell()
            buf = bytearray()
            for i, key in enumerate(k):
                if key == _EMPTY:
                    continue
                self._index[int(key)] = base + len(buf) + 8
                buf += struct.pack("<q", int(key)) + r[i].tobytes()
            self._f.write(bytes(buf))
            self._mm_dirty = True

    def lookup_batch(self, keys) -> Tuple[np.ndarray, np.ndarray]:
        k = np.ascontiguousarray(keys, dtype=np.int64)
        out = np.zeros((len(k), self.width), np.float32)
        found = np.zeros(len(k), bool)
        with self._lock:
            offs = [self._index.get(int(key), -1) for key in k]
            if any(o >= 0 for o in offs):
                self._remap()
                mm = self._mm
                nbytes = 4 * self.width
                for i, o in enumerate(offs):
                    if o >= 0:
                        out[i] = np.frombuffer(mm[o : o + nbytes], np.float32)
                        found[i] = True
        return out, found

    def erase_batch(self, keys) -> np.ndarray:
        k = np.ascontiguousarray(keys, dtype=np.int64)
        found = np.zeros(len(k), bool)
        with self._lock:
            buf = bytearray()
            pad = b"\x00" * (4 * self.width - 8)
            for i, key in enumerate(k):
                if self._index.pop(int(key), None) is not None:
                    found[i] = True
                    # erase marker record: the INT64_MIN sentinel (the one key
                    # insert_batch never writes; a "+1" magic key would
                    # collide with the legal user key INT64_MIN+1), payload =
                    # the erased key
                    buf += struct.pack("<qq", int(_EMPTY), int(key)) + pad
            if buf:
                self._f.write(bytes(buf))
        return found

    def export(self, chunk: int = 65536) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        with self._lock:
            items = list(self._index.items())
            if items:
                self._remap()
        nbytes = 4 * self.width
        for o0 in range(0, len(items), chunk):
            part = items[o0 : o0 + chunk]
            keys = np.array([key for key, _ in part], np.int64)
            rows = np.stack(
                [np.frombuffer(self._mm[o : o + nbytes], np.float32) for _, o in part]
            ) if part else np.zeros((0, self.width), np.float32)
            yield keys, rows

    def compact(self) -> None:
        """Rewrite the log with live records only."""
        with self._lock:
            self._remap()
            tmp = self.path + ".compact"
            nbytes = 4 * self.width
            new_index = {}
            with open(tmp, "wb") as f:
                f.write(_MAGIC + struct.pack("<i", self.width))
                for key, o in self._index.items():
                    new_index[key] = f.tell() + 8
                    f.write(struct.pack("<q", key) + self._mm[o : o + nbytes])
            if self._mm is not None:
                self._mm.close()
                self._mm = None
            self._f.close()
            os.replace(tmp, self.path)
            self._index = new_index
            self._f = open(self.path, "r+b")
            self._f.seek(0, os.SEEK_END)

    def clear(self) -> None:
        with self._lock:
            if self._mm is not None:
                self._mm.close()
                self._mm = None
            self._f.close()
            with open(self.path, "wb") as f:
                f.write(_MAGIC + struct.pack("<i", self.width))
            self._index = {}
            self._f = open(self.path, "r+b")
            self._f.seek(0, os.SEEK_END)

    def close(self) -> None:
        with self._lock:
            if self._mm is not None:
                self._mm.close()
                self._mm = None
            self._f.close()

    def __len__(self) -> int:
        return len(self._index)
