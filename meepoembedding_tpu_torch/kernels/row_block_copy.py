"""Random-row block copies, the port of the TPU kernels K6 and K7 of the
random-row DMA probe `bench_dma.py`: the gather `kernel` of
`make_gather(R, W)` (bench_dma.py:76) and the scatter `kernel` of
`make_scatter(R, W)` (bench_dma.py:137).

    row_block_gather   out[j * R + r] = plane[clip(base[j], 0, nrow - R) + r]
    row_block_scatter  plane[clip(base[j], 0, nrow - R) + r] = upd[j * R + r]

for r < R, on a [nrow, 128] f32 plane; the scatter writes in place and
returns the plane. W is the ring of copies in flight in each block of 256
descriptors: it changes the time, never the result. The scatter is exact
where the descriptors' clipped blocks are disjoint; where two overlap, which
write lands is not defined (on the TPU the later one in grid order, outside
a window of W).

The kernel (`csrc/row_block_copy.cu`) is bound by device memory:
(2 n R 512 + 4 n) bytes / 3.35 TB/s on an H100 SXM. Each descriptor is one
bulk copy of R * 512 bytes into a slot of a ring in shared memory, and one
bulk store out of it, issued by one of eight lanes of its block. A ring of min(W, 256) slots takes
`smem_bytes(R, W)` bytes of shared memory, and a block may have 232,448:
a ring beyond that is refused here, on every device, and `max_ring(R)` is
the largest W that fits. `occupancy(R, W)` is the blocks an SM holds at
once, so the card keeps W x that x SMs descriptors in flight.

The plain versions expand each base to its R rows and copy with
`index_select` / `index_copy_`. Both wrappers count their launches
(`row_block_gather.launches`, `row_block_scatter.launches`).
"""

from __future__ import annotations

import ctypes

import torch

from meepoembedding_tpu_torch.kernels import _build

LANES = 128
ROW_BYTES = LANES * 4
BLOCK_DESC = 256  # descriptors a block, the TPU's grid step
MAX_SMEM = 232_448  # shared memory a block may have on an H100
_BASE_BYTES = BLOCK_DESC * 4
_BARRIER_BYTES = 8


def ring_slots(W: int) -> int:
    """The ring's slots for W: min(W, 256), as the TPU keeps min(W, 256)
    semaphores."""
    return min(W, BLOCK_DESC)


def smem_bytes(R: int, W: int) -> int:
    """Shared memory of a block: the ring of R-row slots, a barrier a slot,
    and the block's 256 bases."""
    return ring_slots(W) * (R * ROW_BYTES + _BARRIER_BYTES) + _BASE_BYTES


def max_ring(R: int) -> int:
    """The largest W <= 256 whose ring fits a block at R rows a descriptor
    (0 if not even one slot fits)."""
    return max(0, min(BLOCK_DESC, (MAX_SMEM - _BASE_BYTES) // (R * ROW_BYTES + _BARRIER_BYTES)))


def block_rows(base: torch.Tensor, R: int, nrow: int) -> torch.Tensor:
    """[n * R] int64 plane rows: each base clipped to [0, nrow - R], then its
    R consecutive rows."""
    first = base.long().clamp(0, nrow - R)
    return (first[:, None] + torch.arange(R, device=base.device)).reshape(-1)


def row_block_gather_plain(plane: torch.Tensor, base: torch.Tensor, R: int) -> torch.Tensor:
    """The plain PyTorch version of the gather: the reference for the kernel."""
    return plane.index_select(0, block_rows(base, R, plane.shape[0]))


def row_block_scatter_plain(plane: torch.Tensor, base: torch.Tensor, upd: torch.Tensor,
                            R: int) -> torch.Tensor:
    """The plain PyTorch version of the scatter, in place."""
    return plane.index_copy_(0, block_rows(base, R, plane.shape[0]), upd)


def _check_ring(name: str, R: int, W: int) -> None:
    if smem_bytes(R, W) > MAX_SMEM:
        raise ValueError(f"{name}: a ring of {ring_slots(W)} slots of {R} rows needs "
                         f"{smem_bytes(R, W)} bytes of shared memory, more than the "
                         f"{MAX_SMEM} a block may have; max_ring({R}) = {max_ring(R)}")


def _check_rows(name: str, what: str, t: torch.Tensor, rows: int, dev) -> None:
    if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != LANES
            or (rows >= 0 and t.shape[0] != rows)):
        want = f"[{rows}, {LANES}]" if rows >= 0 else f"[nrow, {LANES}]"
        raise ValueError(f"{name}: {what} must be {want} float32, got {tuple(t.shape)} {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name}: {what} on {t.device}, base on {dev}: one device for all")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: {what} must be contiguous and 16-byte aligned (bulk copies)")


def _validate(name: str, plane, base, R: int, W: int, upd=None) -> None:
    dev = base.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {dev}, not a CUDA device or the CPU")
    if base.dtype != torch.int32 or base.dim() != 1 or not base.is_contiguous():
        raise ValueError(f"{name}: base must be 1-D contiguous int32, got {base.dtype} "
                         f"{tuple(base.shape)}")
    _check_rows(name, "plane", plane, -1, dev)
    if not 1 <= R <= plane.shape[0]:
        raise ValueError(f"{name}: R = {R} rows a descriptor, not in [1, {plane.shape[0]}]")
    if W < 1:
        raise ValueError(f"{name}: W = {W}, at least one copy in flight")
    _check_ring(name, R, W)
    if upd is not None:
        _check_rows(name, "upd", upd, base.shape[0] * R, dev)


_fns: dict = {}


def _lib():
    lib = _fns.get("lib")
    if lib is None:
        lib = _build.load("row_block_copy")
        fn = lib.meepo_row_block_copy
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        occ = lib.meepo_row_block_occupancy
        occ.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        occ.restype = ctypes.c_int
        _fns["lib"] = lib
    return lib


def _launch(name: str, scatter: int, src, dst, base, nrow: int, R: int, W: int) -> None:
    lib = _lib()
    err = lib.meepo_row_block_copy(scatter, src.data_ptr(), dst.data_ptr(), base.data_ptr(),
                                   base.shape[0], nrow, R, ring_slots(W),
                                   _build.raw_stream(base.device))
    if err:
        _build.check(lib, err, name)


def row_block_gather(plane: torch.Tensor, base: torch.Tensor, R: int, W: int) -> torch.Tensor:
    """[nrow, 128] f32 plane, [n] int32 bases -> [n * R, 128] rows, W copies
    in flight a block. CPU tensors take the plain version; tensors on one
    CUDA device launch the kernel; anything else raises."""
    _validate("row_block_gather", plane, base, R, W)
    if base.device.type == "cpu":
        return row_block_gather_plain(plane, base, R)
    out = torch.empty((base.shape[0] * R, LANES), dtype=torch.float32, device=base.device)
    if base.shape[0]:
        _launch("row_block_gather", 0, plane, out, base, plane.shape[0], R, W)
        row_block_gather.launches += 1
    return out


def row_block_scatter(plane: torch.Tensor, base: torch.Tensor, upd: torch.Tensor, R: int,
                      W: int) -> torch.Tensor:
    """Write upd's [n * R, 128] rows into the plane's blocks, in place;
    returns the plane. Dispatch as `row_block_gather`."""
    _validate("row_block_scatter", plane, base, R, W, upd)
    if base.device.type == "cpu":
        return row_block_scatter_plain(plane, base, upd, R)
    if base.shape[0]:
        _launch("row_block_scatter", 1, upd, plane, base, plane.shape[0], R, W)
        row_block_scatter.launches += 1
    return plane


def occupancy(R: int, W: int) -> int:
    """The blocks of a launch at (R, W) that one SM of the current CUDA
    device holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    if R < 1 or W < 1:
        raise ValueError(f"occupancy: R = {R}, W = {W}; both at least 1")
    _check_ring("occupancy", R, W)
    lib = _lib()
    blocks = ctypes.c_int(0)
    err = lib.meepo_row_block_occupancy(R, ring_slots(W), ctypes.byref(blocks))
    if err:
        _build.check(lib, err, "occupancy")
    return blocks.value


row_block_gather.launches = 0
row_block_scatter.launches = 0
