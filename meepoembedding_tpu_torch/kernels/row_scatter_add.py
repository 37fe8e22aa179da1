"""Row add with unique indices, the port of the TPU kernel K3
(`_scatter_add_kernel`, meepoembedding_tpu/table/pallas_ops.py:187; entry
`row_scatter_add` :253).

    old[j] = plane[idx[j]]     (when `old` is given)
    plane[idx[j]] += upd[j]

in place, for an [R, W] plane of int32 (the add wraps modulo 2^32) or f32.
The rows left after dropping idx outside [0, R) must be unique. K3 clipped
idx >= R onto row R - 1 (pallas_ops.py:130, :138); its callers mean drop
(`mode="drop"`, xla_ops.py:411-412) and this kernel drops such rows. The
bucket planes use it through their flat [nb * 128, 1] view with idx = slot.

With `old`, the launch is a fetch-add: it hands back the rows it read
before adding, as K3 read them into its VMEM slab anyway, so rowwise
AdaGrad reads and adds its accumulator in one launch. A dropped row's `old`
is 0.

The kernel (`csrc/row_scatter_add.cu`) is bound by device memory: it reads
4n bytes of indices, n * W elements of updates and of the plane, and writes
n * W elements (and n * W of `old`). One thread per 16-byte vector (one
element on the flat views); unique rows need no atomics, so the result is
the same on every launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from meepoembedding_tpu_torch.kernels import _build


def row_scatter_add_plain(plane: torch.Tensor, idx: torch.Tensor, upd: torch.Tensor,
                          old: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version: the reference for the kernel. `old` gets
    the kept rows by `index_select`, zeros elsewhere, before the add."""
    i = idx.long()  # in int64: R may be 2^31 (a flat view), beyond int32
    (j,) = ((i >= 0) & (i < plane.shape[0])).nonzero(as_tuple=True)
    if old is not None:
        old.zero_()
        old[j] = plane.index_select(0, i[j])
    plane.index_add_(0, i[j], upd[j])
    return plane


_fns: dict = {}


def _fn():
    fn = _fns.get("add")
    if fn is None:
        fn = _build.load("row_scatter_add").meepo_row_scatter_add
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["add"] = fn
    return fn


def _validate(plane, idx, upd, old):
    if plane.dim() != 2 or plane.dtype not in (torch.int32, torch.float32):
        raise ValueError(
            f"row_scatter_add: plane must be 2-D int32 or float32, "
            f"got {tuple(plane.shape)} {plane.dtype}"
        )
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError(f"row_scatter_add: idx must be 1-D int32, got {idx.dtype}")
    rows = (idx.shape[0], plane.shape[1])
    for name, t in (("upd", upd), ("old", old)):
        if t is not None and (t.dtype != plane.dtype or tuple(t.shape) != rows):
            raise ValueError(
                f"row_scatter_add: {name} {tuple(t.shape)} {t.dtype} does not match "
                f"idx {tuple(idx.shape)} and plane {tuple(plane.shape)} {plane.dtype}"
            )


def row_scatter_add(plane: torch.Tensor, idx: torch.Tensor, upd: torch.Tensor,
                    old: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Add upd[j] to the rows plane[idx[j]], in place; returns `plane`.
    `old` ([n, W], the plane's type), when given, receives each kept row as
    it was before the add, and 0 for a dropped row. CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    _validate(plane, idx, upd, old)
    dev = plane.device
    if idx.device != dev or upd.device != dev or (old is not None and old.device != dev):
        raise ValueError("row_scatter_add: plane, idx, upd and old must lie on one CUDA "
                         "device (or all on the CPU)")
    if dev.type == "cpu":
        return row_scatter_add_plain(plane, idx, upd, old)
    if dev.type != "cuda":
        raise ValueError(f"row_scatter_add: tensors on {dev}, not a CUDA device or the CPU")
    if not (plane.is_contiguous() and idx.is_contiguous() and upd.is_contiguous()
            and (old is None or old.is_contiguous())):
        raise ValueError("row_scatter_add: tensors must be contiguous")
    n = idx.shape[0]
    if n == 0:
        return plane
    err = _fn()(plane.data_ptr(), idx.data_ptr(), upd.data_ptr(),
                None if old is None else old.data_ptr(), n, plane.shape[0], plane.shape[1],
                int(plane.dtype == torch.float32), _build.raw_stream(dev))
    if err:
        _build.check(_build.load("row_scatter_add"), err, "row_scatter_add")
    row_scatter_add.launches += 1
    return plane


row_scatter_add.launches = 0
