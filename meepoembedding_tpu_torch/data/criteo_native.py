"""ctypes binding of the repository's native Criteo TSV parser
(`csrc/criteo_parse.cc`, the same unedited source the JAX package builds).

The library is compiled at first use with g++ into `build/torch_native/`
at the repository root (git-ignored), named by a hash of the source and the
flags, as `backends/host_kv.py` builds `host_kv.cc`; the port never loads
the JAX package's `_native/libcriteoparse.so`. ctypes releases the GIL
around the call, so parsing overlaps the training loop's Python work. The
native parser gives the same batches as `criteo.parse_lines`, bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

NUM_DENSE = 13
NUM_SPARSE = 26

_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_ERR: Optional[str] = None
_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "csrc" / "criteo_parse.cc"
BUILD_DIR = _ROOT / "build" / "torch_native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-march=native")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libcriteoparse-{digest.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """Compile csrc/criteo_parse.cc once (g++) and bind its C interface;
    raises RuntimeError when it cannot be built or loaded."""
    global _LIB, _LIB_ERR
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        if _LIB_ERR is not None:
            raise RuntimeError(_LIB_ERR)
        try:
            so = library_path()
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")  # pid-unique: concurrent builds
                subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
        except (subprocess.SubprocessError, OSError) as e:
            _LIB_ERR = f"criteo_parse build failed: {e}"
            raise RuntimeError(_LIB_ERR) from e
        lib.criteo_parse_batch.restype = ctypes.c_long
        lib.criteo_parse_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_float),
        ]
        _LIB = lib
        return lib


def available() -> bool:
    try:
        load()
        return True
    except RuntimeError:
        return False


def parse_block(block: bytes, max_rows: int):
    """One text block of complete lines -> (rows, dense, ids, label)."""
    lib = load()
    dense = np.zeros((max_rows, NUM_DENSE), np.float32)
    ids = np.zeros((max_rows, NUM_SPARSE), np.int64)
    label = np.zeros((max_rows,), np.float32)
    rows = lib.criteo_parse_batch(
        block, len(block), max_rows,
        dense.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        label.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return rows, dense, ids, label


def parse_lines_native(lines, batch_size: int) -> Iterator[dict]:
    """`criteo.parse_lines` over an iterator of str lines: groups
    `batch_size` lines into one buffer and parses them in one native call;
    a final partial batch is dropped, as there."""
    buf: list = []
    for line in lines:
        buf.append(line if line.endswith("\n") else line + "\n")
        if len(buf) == batch_size:
            rows, dense, ids, label = parse_block("".join(buf).encode(), batch_size)
            if rows != batch_size:
                raise RuntimeError(f"native parser read {rows} of {batch_size} lines")
            yield {"dense": dense, "ids": ids, "label": label}
            buf = []
