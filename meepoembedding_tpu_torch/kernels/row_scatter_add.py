"""Row add with unique indices, the port of the TPU kernel K3
(`_scatter_add_kernel`, meepoembedding_tpu/table/pallas_ops.py:187; entry
`row_scatter_add` :253).

    plane[idx[j]] += upd[j]

in place, for an [R, W] plane of int32 (the add wraps modulo 2^32) or f32.
The rows left after dropping idx outside [0, R) must be unique. K3 clipped
idx >= R onto row R - 1 (pallas_ops.py:130, :138); its callers mean drop
(`mode="drop"`, xla_ops.py:411-412) and this kernel drops such rows. The
bucket planes use it through their flat [nb * 128, 1] view with idx = slot.

The kernel (`csrc/row_scatter_add.cu`) is bound by device memory: it reads
4n bytes of indices, n * W elements of updates and of the plane, and writes
n * W elements. One thread per 16-byte vector of a row; unique rows need no
atomics, so the result is the same on every launch.
"""

from __future__ import annotations

import ctypes

import torch

from meepoembedding_tpu_torch.kernels import _build


def row_scatter_add_plain(plane: torch.Tensor, idx: torch.Tensor,
                          upd: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the reference for the kernel."""
    i = idx.long()  # in int64: R may be 2^31 (a flat view), beyond int32
    (j,) = ((i >= 0) & (i < plane.shape[0])).nonzero(as_tuple=True)
    plane.index_add_(0, i[j], upd[j])
    return plane


def _lib():
    lib = _build.load("row_scatter_add")
    fn = lib.meepo_row_scatter_add
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _validate(plane, idx, upd):
    if plane.dim() != 2 or plane.dtype not in (torch.int32, torch.float32):
        raise ValueError(
            f"row_scatter_add: plane must be 2-D int32 or float32, "
            f"got {tuple(plane.shape)} {plane.dtype}"
        )
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError(f"row_scatter_add: idx must be 1-D int32, got {idx.dtype}")
    if upd.dtype != plane.dtype or tuple(upd.shape) != (idx.shape[0], plane.shape[1]):
        raise ValueError(
            f"row_scatter_add: upd {tuple(upd.shape)} {upd.dtype} does not match "
            f"idx {tuple(idx.shape)} and plane {tuple(plane.shape)} {plane.dtype}"
        )


def row_scatter_add(plane: torch.Tensor, idx: torch.Tensor, upd: torch.Tensor) -> torch.Tensor:
    """Add upd[j] to the rows plane[idx[j]], in place; returns `plane`. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    _validate(plane, idx, upd)
    tensors = (plane, idx, upd)
    if all(t.device.type == "cpu" for t in tensors):
        return row_scatter_add_plain(plane, idx, upd)
    if plane.device.type != "cuda" or any(t.device != plane.device for t in tensors):
        raise ValueError(
            "row_scatter_add: plane, idx and upd must lie on one CUDA device "
            "(or all on the CPU)"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("row_scatter_add: tensors must be contiguous")
    n = idx.shape[0]
    if n == 0:
        return plane
    lib = _lib()
    stream = torch.cuda.current_stream(plane.device).cuda_stream
    err = lib.meepo_row_scatter_add(
        plane.data_ptr(), idx.data_ptr(), upd.data_ptr(), n, plane.shape[0],
        plane.shape[1], int(plane.dtype == torch.float32), stream,
    )
    _build.check(lib, err, "row_scatter_add")
    row_scatter_add.launches += 1
    return plane


row_scatter_add.launches = 0
