"""Row gather, the port of the TPU kernel K2 (`_gather_kernel`,
meepoembedding_tpu/table/pallas_ops.py:58; entry `row_gather` :110).

    out_p[j] = plane_p[clamp(idx[j], 0, R - 1)]     for each plane p

for [R, W] planes of one shape and one element size (2 or 4 bytes) that
share the int32 index. Callers zero the rows they consider missing
(slot < 0), as `xla_ops.lookup_rows` does.

`row_gather_multi(planes, idx)` gathers up to `MAX_PLANES` planes in one
launch, each row's index loaded once for all of them (the probe's key_hi and
key_lo rows, the Adam moments); `row_gather(plane, idx)` is its one-plane
case. Both count their launches in `row_gather.launches`.

The kernel (`csrc/row_gather.cu`) is bound by device memory: the least time
is (4 n + 2 k n W elem) bytes / 3.35 TB/s on an H100 SXM. One thread per
16-byte vector (4-byte on the flat views) loads its index and the vector of
every plane before it stores any.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from meepoembedding_tpu_torch.kernels import _build

MAX_PLANES = 4


class _GatherPlanes(ctypes.Structure):
    """`GatherPlanes` of csrc/row_gather.cu."""

    _fields_ = [("plane", ctypes.c_void_p * MAX_PLANES),
                ("out", ctypes.c_void_p * MAX_PLANES),
                ("k", ctypes.c_int)]


def row_gather_plain(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the reference for the kernel."""
    return plane.index_select(0, idx.long().clamp(0, plane.shape[0] - 1))


def row_gather_multi_plain(planes: Sequence[torch.Tensor],
                           idx: torch.Tensor) -> List[torch.Tensor]:
    """The plain version of the multi-plane gather: one `row_gather_plain` a
    plane."""
    return [row_gather_plain(p, idx) for p in planes]


_fns: dict = {}


def _fn():
    fn = _fns.get("gather")
    if fn is None:
        fn = _build.load("row_gather").meepo_row_gather
        fn.argtypes = [ctypes.POINTER(_GatherPlanes), ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["gather"] = fn
    return fn


def row_gather_multi(planes: Sequence[torch.Tensor], idx: torch.Tensor) -> List[torch.Tensor]:
    """[R, W] planes of one shape and element size, [n] int32 idx -> one
    [n, W] tensor of rows a plane (idx clamped into range), in one launch.
    CPU tensors take the plain version; tensors on one CUDA device launch the
    kernel; any other mix raises."""
    k = len(planes)
    if not 1 <= k <= MAX_PLANES:
        raise ValueError(f"row_gather: 1 to {MAX_PLANES} planes, got {k}")
    p0 = planes[0]
    shape, esize, dev = p0.shape, p0.element_size(), idx.device
    if len(shape) != 2 or esize not in (2, 4) or shape[0] == 0:
        raise ValueError(f"row_gather: a plane is a non-empty 2-D tensor of 2- or 4-byte "
                         f"elements, got {tuple(shape)} {p0.dtype}")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError(f"row_gather: idx must be 1-D int32, got {idx.dtype} {tuple(idx.shape)}")
    for p in planes:
        if p.device != dev or (p is not p0 and (p.shape != shape or p.element_size() != esize)):
            raise ValueError(f"row_gather: the planes of one launch share shape and element "
                             f"size, and lie with idx on one CUDA device (or all on the CPU): "
                             f"{tuple(p.shape)} {p.dtype} on {p.device}, {tuple(shape)} "
                             f"{p0.dtype}, idx on {dev}")
    if dev.type == "cpu":
        return row_gather_multi_plain(planes, idx)
    if dev.type != "cuda":
        raise ValueError(f"row_gather: tensors on {dev}, not a CUDA device or the CPU")
    if not (idx.is_contiguous() and all(p.is_contiguous() for p in planes)):
        raise ValueError("row_gather: tensors must be contiguous")
    n = idx.shape[0]
    outs = [torch.empty((n, shape[1]), dtype=p.dtype, device=dev) for p in planes]
    if n == 0:
        return outs
    gp = _GatherPlanes()
    for i, (p, o) in enumerate(zip(planes, outs)):
        gp.plane[i] = p.data_ptr()
        gp.out[i] = o.data_ptr()
    gp.k = k
    err = _fn()(ctypes.byref(gp), idx.data_ptr(), n, shape[0], shape[1] * esize,
                _build.raw_stream(dev))
    if err:
        _build.check(_build.load("row_gather"), err, "row_gather")
    row_gather.launches += 1
    return outs


def row_gather(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[R, W] plane, [n] int32 idx -> [n, W] rows (idx clamped into range).
    The one-plane case of `row_gather_multi`."""
    return row_gather_multi((plane,), idx)[0]


row_gather.launches = 0
