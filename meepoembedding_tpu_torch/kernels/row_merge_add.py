"""Row merge-add with duplicate rows, the port of the TPU kernel K1
(`_kernel`, meepoembedding_tpu/table/stream_merge.py:61; entry
`stream_merge_add` :524, dispatched by `values_scatter_add` :562).

    plane[vrow[j]] += upd[j]

in place, for an [R, W] plane of f32 or bf16 and [m, W] f32 updates.
Duplicate rows are summed; rows outside [0, R) are dropped. The sum runs in
f32 from the old row through the updates in input order, and is rounded to
the plane's type once. K1 cast the updates to the plane's type and added in
that type, so on a bf16 plane the two may differ by one bf16 unit in the
last place.

The wrapper sorts the rows stably (`torch.sort`, as the JAX wrapper sorts
outside its kernel); the kernel (`csrc/row_merge_add.cu`) gives each run of
equal rows to one warp, which reads the row once, adds the run's updates in
sorted order and writes it once. No atomics: the same inputs give the same
bits on every launch. It is bound by device memory.
"""

from __future__ import annotations

import ctypes

import torch

from meepoembedding_tpu_torch.kernels import _build


def row_merge_add_plain(plane: torch.Tensor, vrow: torch.Tensor,
                        upd: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the touched rows gathered to f32, the
    updates added with `index_add_` in f32, the sums cast and written back.
    On the CPU `index_add_` adds in input order, as the kernel does; on the
    card it adds duplicates with atomics, in no fixed order."""
    v = vrow.long()
    (j,) = ((v >= 0) & (v < plane.shape[0])).nonzero(as_tuple=True)
    rows, inv = torch.unique(v[j], return_inverse=True)
    acc = plane[rows].float()
    acc.index_add_(0, inv, upd[j].float())
    plane[rows] = acc.to(plane.dtype)
    return plane


def _lib():
    lib = _build.load("row_merge_add")
    fn = lib.meepo_row_merge_add
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _validate(plane, vrow, upd):
    if plane.dim() != 2 or plane.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"row_merge_add: plane must be 2-D float32 or bfloat16, "
            f"got {tuple(plane.shape)} {plane.dtype}"
        )
    if vrow.dtype != torch.int32 or vrow.dim() != 1:
        raise ValueError(f"row_merge_add: vrow must be 1-D int32, got {vrow.dtype}")
    if upd.dtype != torch.float32 or tuple(upd.shape) != (vrow.shape[0], plane.shape[1]):
        raise ValueError(
            f"row_merge_add: upd must be float32 [{vrow.shape[0]}, {plane.shape[1]}], "
            f"got {tuple(upd.shape)} {upd.dtype}"
        )


def row_merge_add(plane: torch.Tensor, vrow: torch.Tensor, upd: torch.Tensor) -> torch.Tensor:
    """Add upd[j] to plane[vrow[j]] in place, summing duplicates; returns
    `plane`. CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    _validate(plane, vrow, upd)
    tensors = (plane, vrow, upd)
    if all(t.device.type == "cpu" for t in tensors):
        return row_merge_add_plain(plane, vrow, upd)
    if plane.device.type != "cuda" or any(t.device != plane.device for t in tensors):
        raise ValueError(
            "row_merge_add: plane, vrow and upd must lie on one CUDA device "
            "(or all on the CPU)"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("row_merge_add: tensors must be contiguous")
    m = vrow.shape[0]
    if m == 0:
        return plane
    # rows to drop sort to either end of the keys, where the kernel skips them
    skey, order = torch.sort(vrow, stable=True)
    lib = _lib()
    stream = torch.cuda.current_stream(plane.device).cuda_stream
    err = lib.meepo_row_merge_add(
        plane.data_ptr(), skey.data_ptr(), order.data_ptr(), upd.data_ptr(), m,
        plane.shape[0], plane.shape[1], int(plane.dtype == torch.bfloat16), stream,
    )
    _build.check(lib, err, "row_merge_add")
    row_merge_add.launches += 1
    return plane


row_merge_add.launches = 0
