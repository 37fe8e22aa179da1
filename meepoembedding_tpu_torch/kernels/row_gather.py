"""Row gather, the port of the TPU kernel K2 (`_gather_kernel`,
meepoembedding_tpu/table/pallas_ops.py:58; entry `row_gather` :110).

    out[j] = plane[clamp(idx[j], 0, R - 1)]

for an [R, W] plane of 2- or 4-byte elements and int32 indices. Callers zero
the rows they consider missing (slot < 0), as `xla_ops.lookup_rows` does.

The kernel (`csrc/row_gather.cu`) is bound by device memory: the least time
is (2 * n * W * elem + 4 * n) bytes / 3.35 TB/s on an H100 SXM. It reads
each row with coalesced 16-byte accesses, one thread per 16-byte vector.
"""

from __future__ import annotations

import ctypes

import torch

from meepoembedding_tpu_torch.kernels import _build


def row_gather_plain(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the reference for the kernel."""
    return plane.index_select(0, idx.long().clamp(0, plane.shape[0] - 1))


def _lib():
    lib = _build.load("row_gather")
    fn = lib.meepo_row_gather
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def row_gather(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[R, W] plane, [n] int32 idx -> [n, W] rows (idx clamped into range).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if plane.device.type == "cpu" and idx.device.type == "cpu":
        return row_gather_plain(plane, idx)
    if plane.device.type != "cuda" or idx.device != plane.device:
        raise ValueError(
            f"row_gather: plane on {plane.device}, idx on {idx.device}; both "
            "must be on one CUDA device (or both on the CPU)"
        )
    if plane.dim() != 2 or not plane.is_contiguous() or plane.element_size() not in (2, 4):
        raise ValueError(
            f"row_gather: plane must be a contiguous 2-D tensor of 2- or 4-byte "
            f"elements, got {tuple(plane.shape)} {plane.dtype}"
        )
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"row_gather: idx must be contiguous 1-D int32, got {idx.dtype}")
    if plane.shape[0] == 0:
        raise ValueError("row_gather: empty plane")
    n, (R, W) = idx.shape[0], plane.shape
    out = torch.empty((n, W), dtype=plane.dtype, device=plane.device)
    if n == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(plane.device).cuda_stream
    err = lib.meepo_row_gather(plane.data_ptr(), idx.data_ptr(), out.data_ptr(),
                               n, R, W * plane.element_size(), stream)
    _build.check(lib, err, "row_gather")
    row_gather.launches += 1
    return out


row_gather.launches = 0
