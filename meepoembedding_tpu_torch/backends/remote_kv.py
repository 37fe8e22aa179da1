"""Remote-KV tier (a copy of `meepoembedding_tpu/backends/remote_kv.py`): a
network backend speaking RESP, the Redis protocol, as a cold/overflow tier
shared across jobs.

A minimal dependency-free RESP2 client over one TCP socket: batch ops
pipeline MSET / MGET / DEL over the single round trip. Rows travel as raw
float32 little-endian bytes under keys "<prefix>:<int64>". Works against any
RESP server; tests run against a tiny in-process fake (tests/fake_resp.py),
so CI needs no redis installation.
"""

from __future__ import annotations

import socket
import threading
from typing import Iterator, List, Tuple

import numpy as np

_EMPTY = np.int64(-(2**63))


class RespClient:
    """Pipelined RESP2 codec over one socket."""

    def __init__(self, host: str, port: int, timeout: float = 5.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._buf = b""
        self._lock = threading.Lock()

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass

    @staticmethod
    def _encode(cmd: List[bytes]) -> bytes:
        out = [b"*%d\r\n" % len(cmd)]
        for a in cmd:
            out.append(b"$%d\r\n%s\r\n" % (len(a), a))
        return b"".join(out)

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("RESP server closed connection")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n + 2:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("RESP server closed connection")
            self._buf += chunk
        data, self._buf = self._buf[:n], self._buf[n + 2 :]
        return data

    def _read_reply(self):
        line = self._read_line()
        t, rest = line[:1], line[1:]
        if t == b"+":
            return rest
        if t == b"-":
            raise RuntimeError(f"RESP error: {rest.decode()}")
        if t == b":":
            return int(rest)
        if t == b"$":
            n = int(rest)
            return None if n == -1 else self._read_exact(n)
        if t == b"*":
            n = int(rest)
            return None if n == -1 else [self._read_reply() for _ in range(n)]
        raise RuntimeError(f"bad RESP type byte: {line!r}")

    def pipeline(self, cmds: List[List[bytes]]) -> list:
        """Send all commands in one write, read all replies."""
        with self._lock:
            self._sock.sendall(b"".join(self._encode(c) for c in cmds))
            return [self._read_reply() for _ in cmds]


class RemoteKVStore:
    """KVBackend over a RESP server."""

    def __init__(
        self,
        width: int,
        host: str = "127.0.0.1",
        port: int = 6379,
        prefix: str = "meepo",
        timeout: float = 5.0,
        batch: int = 4096,
    ):
        self.width = int(width)
        self.prefix = prefix.encode()
        self._batch = batch
        self._client = RespClient(host, port, timeout)

    def _key(self, k: int) -> bytes:
        return self.prefix + b":" + str(int(k)).encode()

    def insert_batch(self, keys, rows) -> None:
        k = np.ascontiguousarray(keys, dtype=np.int64)
        r = np.ascontiguousarray(rows, dtype=np.float32)
        assert r.shape == (len(k), self.width)
        cmds = []
        for o in range(0, len(k), self._batch):
            cmd = [b"MSET"]
            for i in range(o, min(len(k), o + self._batch)):
                if k[i] == _EMPTY:
                    continue
                cmd += [self._key(k[i]), r[i].tobytes()]
            if len(cmd) > 1:
                cmds.append(cmd)
        if cmds:
            self._client.pipeline(cmds)

    def lookup_batch(self, keys) -> Tuple[np.ndarray, np.ndarray]:
        k = np.ascontiguousarray(keys, dtype=np.int64)
        out = np.zeros((len(k), self.width), np.float32)
        found = np.zeros(len(k), bool)
        for o in range(0, len(k), self._batch):
            idx = range(o, min(len(k), o + self._batch))
            cmd = [b"MGET"] + [self._key(k[i]) for i in idx]
            (replies,) = self._client.pipeline([cmd])
            for j, i in enumerate(idx):
                v = replies[j]
                if v is not None and len(v) == 4 * self.width:
                    out[i] = np.frombuffer(v, np.float32)
                    found[i] = True
        return out, found

    def erase_batch(self, keys) -> np.ndarray:
        k = np.ascontiguousarray(keys, dtype=np.int64)
        found = np.zeros(len(k), bool)
        for o in range(0, len(k), self._batch):
            idx = list(range(o, min(len(k), o + self._batch)))
            cmds = [[b"DEL", self._key(k[i])] for i in idx]
            replies = self._client.pipeline(cmds)
            for j, i in enumerate(idx):
                found[i] = bool(replies[j])
        return found

    def export(self, chunk: int = 4096) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        cursor = b"0"
        plen = len(self.prefix) + 1
        while True:
            (reply,) = self._client.pipeline(
                [[b"SCAN", cursor, b"MATCH", self.prefix + b":*", b"COUNT", b"%d" % chunk]]
            )
            cursor, names = reply[0], reply[1]
            if names:
                (rows,) = self._client.pipeline([[b"MGET"] + names])
                keys, vals = [], []
                for name, v in zip(names, rows):
                    if v is not None and len(v) == 4 * self.width:
                        keys.append(int(name[plen:]))
                        vals.append(np.frombuffer(v, np.float32))
                if keys:
                    yield np.array(keys, np.int64), np.stack(vals)
            if cursor == b"0":
                return

    def clear(self) -> None:
        for keys, _ in list(self.export()):
            self.erase_batch(keys)

    def __len__(self) -> int:
        n = 0
        for keys, _ in self.export():
            n += len(keys)
        return n

    def close(self) -> None:
        self._client.close()
