"""Row set, the port of the TPU kernels K4 (`_scatter_set_kernel`,
meepoembedding_tpu/table/pallas_ops.py:200) and K5 (`_kernel_set`,
meepoembedding_tpu/table/stream_merge.py:224) as one kernel.

    plane_p[idx[j]] = value_p[j]     for each plane p that shares idx

in place, for [R, W] planes of one shape and one element size (2 or 4
bytes). Each value is an [n, W] tensor of the plane's type or a Python
scalar, which the kernel receives as bits and writes to every row, so no
tensor is built for it. Rows with idx outside [0, R) are dropped; the rows
left must be unique. K4 and K5 set the lanes of 128-lane rows under a mask
(K5 with duplicate rows whose masks are disjoint); that is this set on the
plane's flat `view(-1, 1)` with one index per masked element,
`row * W + lane`, which makes the indices unique. K4 clipped idx >= R onto
row R - 1; no caller relies on that and this kernel drops such rows, as K5
and the JAX callers' `mode="drop"` do.

`row_scatter_set_multi(planes, idx, values)` sets up to `MAX_PLANES` planes
in one launch; `row_scatter_set(plane, idx, upd)` is its one-plane case.
Both count their launches in `row_scatter_set.launches`.

The kernel (`csrc/row_scatter_set.cu`) is bound by device memory: it reads
4n bytes of indices and each tensor value once, and writes n * W elements
of each plane. One thread per 16-byte vector of a row makes every write
independent; the thread loads its index once and stores to every plane.
"""

from __future__ import annotations

import ctypes
import numbers
import struct
from typing import Sequence, Union

import torch

from meepoembedding_tpu_torch.kernels import _build

MAX_PLANES = 8

Value = Union[torch.Tensor, numbers.Number]


class _SetPlanes(ctypes.Structure):
    """`SetPlanes` of csrc/row_scatter_set.cu."""

    _fields_ = [("plane", ctypes.c_void_p * MAX_PLANES),
                ("upd", ctypes.c_void_p * MAX_PLANES),
                ("scalar", ctypes.c_uint32 * MAX_PLANES),
                ("k", ctypes.c_int)]


def _scalar_bits(v, dtype: torch.dtype) -> int:
    """The bits of `v` in `dtype` (int32 wraps, floats round to nearest),
    repeated to 32 bits for a 2-byte type."""
    if dtype == torch.int32:
        return int(v) & 0xFFFFFFFF
    if dtype == torch.float32:
        return struct.unpack("<I", struct.pack("<f", float(v)))[0]
    b = int(torch.tensor(v, dtype=dtype).view(torch.int16).item()) & 0xFFFF
    return b | (b << 16)


def _scalar_rows(v, plane: torch.Tensor, n: int) -> torch.Tensor:
    """[n, W] rows of the scalar's bits, for the plain version."""
    bits = _scalar_bits(v, plane.dtype)
    if plane.element_size() == 4:
        word, dtype = bits - (1 << 32) * (bits >> 31), torch.int32
    else:
        word, dtype = (bits & 0xFFFF) - (1 << 16) * ((bits >> 15) & 1), torch.int16
    return torch.full((n, plane.shape[1]), word, dtype=dtype,
                      device=plane.device).view(plane.dtype)


def row_scatter_set_plain(plane: torch.Tensor, idx: torch.Tensor,
                          upd: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the reference for the kernel."""
    i = idx.long()  # in int64: R may be 2^31 (a flat view), beyond int32
    (j,) = ((i >= 0) & (i < plane.shape[0])).nonzero(as_tuple=True)
    plane[i[j]] = upd[j]
    return plane


def row_scatter_set_multi_plain(planes: Sequence[torch.Tensor], idx: torch.Tensor,
                                values: Sequence[Value]) -> None:
    """The plain version of the multi-plane set: one `row_scatter_set_plain`
    a plane, scalars expanded to rows of their bits."""
    for plane, v in zip(planes, values):
        if not isinstance(v, torch.Tensor):
            v = _scalar_rows(v, plane, idx.shape[0])
        row_scatter_set_plain(plane, idx, v)


_fns: dict = {}


def _fn():
    fn = _fns.get("set")
    if fn is None:
        fn = _build.load("row_scatter_set").meepo_row_scatter_set
        fn.argtypes = [ctypes.POINTER(_SetPlanes), ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["set"] = fn
    return fn


def _validate(planes, idx, values):
    if not 1 <= len(planes) <= MAX_PLANES or len(values) != len(planes):
        raise ValueError(f"row_scatter_set: 1 to {MAX_PLANES} planes, one value each; "
                         f"got {len(planes)} planes, {len(values)} values")
    p0 = planes[0]
    for plane in planes:
        if plane.dim() != 2 or plane.element_size() not in (2, 4):
            raise ValueError(
                f"row_scatter_set: plane must be 2-D with 2- or 4-byte elements, "
                f"got {tuple(plane.shape)} {plane.dtype}"
            )
        if plane.shape != p0.shape or plane.element_size() != p0.element_size():
            raise ValueError(f"row_scatter_set: planes of one launch must share shape and "
                             f"element size: {tuple(plane.shape)} {plane.dtype} vs "
                             f"{tuple(p0.shape)} {p0.dtype}")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError(f"row_scatter_set: idx must be 1-D int32, got {idx.dtype}")
    for plane, v in zip(planes, values):
        if isinstance(v, torch.Tensor):
            if v.dtype != plane.dtype or tuple(v.shape) != (idx.shape[0], plane.shape[1]):
                raise ValueError(
                    f"row_scatter_set: upd {tuple(v.shape)} {v.dtype} does not match "
                    f"idx {tuple(idx.shape)} and plane {tuple(plane.shape)} {plane.dtype}"
                )
        elif not isinstance(v, numbers.Number):
            raise ValueError(f"row_scatter_set: a value is an [n, W] tensor or a Python "
                             f"number, got {type(v).__name__}")


def _pack(planes, values) -> _SetPlanes:
    """The kernel's argument struct: each plane's pointer and its value's
    pointer or scalar bits."""
    sp = _SetPlanes()
    for p, (plane, v) in enumerate(zip(planes, values)):
        sp.plane[p] = plane.data_ptr()
        if isinstance(v, torch.Tensor):
            sp.upd[p] = v.data_ptr()
        else:
            sp.scalar[p] = _scalar_bits(v, plane.dtype)
    sp.k = len(planes)
    return sp


def row_scatter_set_multi(planes: Sequence[torch.Tensor], idx: torch.Tensor,
                          values: Sequence[Value]) -> None:
    """Set plane[idx[j]] = value[j] (a tensor row, or the scalar) in each
    plane, in place, in one launch. CPU tensors take the plain version;
    tensors on one CUDA device launch the kernel; any other mix raises."""
    _validate(planes, idx, values)
    tensors = [idx, *planes, *(v for v in values if isinstance(v, torch.Tensor))]
    dev = idx.device
    if any(t.device != dev for t in tensors):
        raise ValueError("row_scatter_set: planes, idx and values must lie on one CUDA "
                         "device (or all on the CPU)")
    if dev.type == "cpu":
        row_scatter_set_multi_plain(planes, idx, values)
        return
    if dev.type != "cuda":
        raise ValueError(f"row_scatter_set: tensors on {dev}, not a CUDA device or the CPU")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("row_scatter_set: tensors must be contiguous")
    n = idx.shape[0]
    if n == 0:
        return
    p0 = planes[0]
    err = _fn()(ctypes.byref(_pack(planes, values)), idx.data_ptr(), n, p0.shape[0],
                p0.shape[1], p0.element_size(), _build.raw_stream(dev))
    if err:
        _build.check(_build.load("row_scatter_set"), err, "row_scatter_set")
    row_scatter_set.launches += 1


def row_scatter_set(plane: torch.Tensor, idx: torch.Tensor, upd: torch.Tensor) -> torch.Tensor:
    """Set the rows plane[idx[j]] to upd[j], in place; returns `plane`. The
    one-plane case of `row_scatter_set_multi`."""
    row_scatter_set_multi((plane,), idx, (upd,))
    return plane


row_scatter_set.launches = 0
