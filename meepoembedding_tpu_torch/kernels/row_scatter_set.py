"""Row set, the port of the TPU kernels K4 (`_scatter_set_kernel`,
meepoembedding_tpu/table/pallas_ops.py:200) and K5 (`_kernel_set`,
meepoembedding_tpu/table/stream_merge.py:224) as one kernel.

    plane[idx[j]] = upd[j]

in place, for an [R, W] plane of 2- or 4-byte elements. Rows with idx outside
[0, R) are dropped; the rows left must be unique. K4 and K5 set the lanes of
128-lane rows under a mask (K5 with duplicate rows whose masks are
disjoint); that is this set on the plane's flat `view(-1, 1)` with one index
per masked element, `row * W + lane`, which makes the indices unique. K4
clipped idx >= R onto row R - 1; no caller relies on that and this kernel
drops such rows, as K5 and the JAX callers' `mode="drop"` do.

The kernel (`csrc/row_scatter_set.cu`) is bound by device memory: it reads
4n bytes of indices and n * W elements of updates, and writes n * W
elements. One thread per 16-byte vector of a row makes every write
independent.
"""

from __future__ import annotations

import ctypes

import torch

from meepoembedding_tpu_torch.kernels import _build


def row_scatter_set_plain(plane: torch.Tensor, idx: torch.Tensor,
                          upd: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the reference for the kernel."""
    i = idx.long()  # in int64: R may be 2^31 (a flat view), beyond int32
    (j,) = ((i >= 0) & (i < plane.shape[0])).nonzero(as_tuple=True)
    plane[i[j]] = upd[j]
    return plane


def _lib():
    lib = _build.load("row_scatter_set")
    fn = lib.meepo_row_scatter_set
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _validate(plane, idx, upd):
    if plane.dim() != 2 or plane.element_size() not in (2, 4):
        raise ValueError(
            f"row_scatter_set: plane must be 2-D with 2- or 4-byte elements, "
            f"got {tuple(plane.shape)} {plane.dtype}"
        )
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError(f"row_scatter_set: idx must be 1-D int32, got {idx.dtype}")
    if upd.dtype != plane.dtype or tuple(upd.shape) != (idx.shape[0], plane.shape[1]):
        raise ValueError(
            f"row_scatter_set: upd {tuple(upd.shape)} {upd.dtype} does not match "
            f"idx {tuple(idx.shape)} and plane {tuple(plane.shape)} {plane.dtype}"
        )


def row_scatter_set(plane: torch.Tensor, idx: torch.Tensor, upd: torch.Tensor) -> torch.Tensor:
    """Set the rows plane[idx[j]] to upd[j], in place; returns `plane`. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    _validate(plane, idx, upd)
    tensors = (plane, idx, upd)
    if all(t.device.type == "cpu" for t in tensors):
        return row_scatter_set_plain(plane, idx, upd)
    if plane.device.type != "cuda" or any(t.device != plane.device for t in tensors):
        raise ValueError(
            "row_scatter_set: plane, idx and upd must lie on one CUDA device "
            "(or all on the CPU)"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("row_scatter_set: tensors must be contiguous")
    n = idx.shape[0]
    if n == 0:
        return plane
    lib = _lib()
    stream = torch.cuda.current_stream(plane.device).cuda_stream
    err = lib.meepo_row_scatter_set(
        plane.data_ptr(), idx.data_ptr(), upd.data_ptr(),
        n, plane.shape[0], plane.shape[1], plane.element_size(), stream,
    )
    _build.check(lib, err, "row_scatter_set")
    row_scatter_set.launches += 1
    return plane


row_scatter_set.launches = 0
