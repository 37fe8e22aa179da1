"""Row merge-add, the port of the TPU kernel K1 (`_kernel`,
meepoembedding_tpu/table/stream_merge.py:61; entry `stream_merge_add` :524,
dispatched by `values_scatter_add` :562).

    plane[vrow[j]] += upd[j]

for an [R, W] plane of f32 or bf16 and [m, W] f32 updates. Rows outside
[0, R) are dropped. The sum runs in f32 from the old row through the
updates in input order, and is rounded to the plane's type once. K1 cast
the updates to the plane's type and added in that type, so on a bf16 plane
the two may differ by one bf16 unit in the last place.

Two wrappers share one plain version and one launch counter,
`row_merge_add.launches`:

- `row_merge_add(plane, vrow, upd)` adds in place, for rows that the caller
  guarantees unique among those in [0, R): every values-plane update (one
  slot per unique id). There is no sort: one launch adds each valid row
  once, one thread per 16-byte vector. Duplicates would race on the card,
  so the contract is the caller's to keep.
- `segment_sum(upd, vrow, num_rows, order, sorted_rows)` sums duplicates: a
  new zeroed [num_rows, W] f32 output with the updates summed into it, the
  backward of a gather by `vrow`. The caller may pass the stable sort it
  already has (`sorted_rows` = vrow[order], non-decreasing), as the dedup
  does; else the wrapper sorts. A memset zeroes the output, a walk in fixed
  segments of `segment_size()` positions (one warp each) sums each run of at
  most that many updates in input order, and a combine pass adds the
  per-segment partials of longer runs in segment order: two kernels, counted
  as two launches. No atomics: the same inputs give the same bits on every
  launch.
- `segment_sum_gather(src, order, sorted_rows, num_rows)` is the same two
  kernels with `order` read as rows of any [R, W] source: out[sorted_rows[k]]
  += src[order[k]]. A multi-hot bag's pooled row is one such run (the bag's
  ids in order, `order` their unique rows), and so is its backward (the
  dedup's sorted ids, `order` the bag of each): no [m, W] rows are made.

Both kernels (`csrc/row_merge_add.cu`) are bound by device memory.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from meepoembedding_tpu_torch.kernels import _build


def row_merge_add_plain(plane: torch.Tensor, vrow: torch.Tensor,
                        upd: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the touched rows gathered to f32, the
    updates added with `index_add_` in f32, the sums cast and written back.
    On the CPU `index_add_` adds in input order, as the kernels do; on the
    card it adds duplicates with atomics, in no fixed order."""
    v = vrow.long()
    (j,) = ((v >= 0) & (v < plane.shape[0])).nonzero(as_tuple=True)
    rows, inv = torch.unique(v[j], return_inverse=True)
    acc = plane[rows].float()
    acc.index_add_(0, inv, upd[j].float())
    plane[rows] = acc.to(plane.dtype)
    return plane


_fns: dict = {}


def _fn(name: str, argtypes):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("row_merge_add"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_UNIQUE_ARGS = [_P, _P, _P, _L, _L, _L, _I, _P]
_SUM_ARGS = [_P, _P, _P, _P, _P, _L, _L, _L, _P]


@functools.cache
def segment_size() -> int:
    """The positions a warp of the segment sum walks, a constant of the
    kernel source (builds and loads it): runs of at most this many updates
    are summed exactly in input order."""
    return _fn("meepo_segment_size", [])()


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


def _on_card(tensors) -> bool:
    """False for tensors that all lie on the CPU, True for contiguous tensors
    on one CUDA device; raises for anything else."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("row_merge_add: the tensors must lie on one CUDA device "
                         "(or all on the CPU)")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"row_merge_add: tensors on {dev}, not a CUDA device or the CPU")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("row_merge_add: tensors must be contiguous")
    return True


def row_merge_add(plane: torch.Tensor, vrow: torch.Tensor, upd: torch.Tensor) -> torch.Tensor:
    """Add upd[j] to plane[vrow[j]] in place; returns `plane`. The rows in
    [0, R) must be unique (on the card duplicates race; `segment_sum` sums
    them). CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    _validate(plane, vrow, upd)
    if not _on_card((plane, vrow, upd)):
        return row_merge_add_plain(plane, vrow, upd)
    m = vrow.shape[0]
    if m == 0:
        return plane
    err = _fn("meepo_row_add_unique", _UNIQUE_ARGS)(
        plane.data_ptr(), vrow.data_ptr(), upd.data_ptr(), m, plane.shape[0],
        plane.shape[1], int(plane.dtype == torch.bfloat16), _build.raw_stream(plane.device),
    )
    if err:
        _build.check(_build.load("row_merge_add"), err, "row_merge_add")
    row_merge_add.launches += 1
    return plane


def segment_sum(upd: torch.Tensor, vrow: torch.Tensor, num_rows: int,
                order: Optional[torch.Tensor] = None,
                sorted_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[m, W] f32 updates -> [num_rows, W] f32 with out[vrow[j]] += upd[j]
    from zero; rows outside [0, num_rows) are dropped. `order` (int64 [m])
    and `sorted_rows` (int32 [m], vrow[order], non-decreasing) are the
    rows' stable sort where the caller has it; the wrapper sorts when they
    are not given. CPU tensors take the plain version (in input order, which
    needs no sort); CUDA tensors launch the kernels."""
    m, width = vrow.shape[0], upd.shape[1]
    if (order is None) != (sorted_rows is None):
        raise ValueError("segment_sum: pass both order and sorted_rows, or neither")
    given = () if order is None else (order, sorted_rows)
    if given and (order.dtype != torch.int64 or sorted_rows.dtype != torch.int32
                  or order.shape != vrow.shape or sorted_rows.shape != vrow.shape):
        raise ValueError(f"segment_sum: order must be int64 and sorted_rows int32, both "
                         f"[{vrow.shape[0]}]; got {order.dtype} {tuple(order.shape)} and "
                         f"{sorted_rows.dtype} {tuple(sorted_rows.shape)}")
    if not _on_card((vrow, upd, *given)):
        out = torch.zeros((num_rows, width), dtype=torch.float32)
        _validate(out, vrow, upd)
        return row_merge_add_plain(out, vrow, upd)
    return _segment_sum_card(upd, order, sorted_rows, num_rows, vrow)


def _segment_sum_card(src: torch.Tensor, order: Optional[torch.Tensor],
                      sorted_rows: Optional[torch.Tensor], num_rows: int,
                      vrow: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernels' launch: out[sorted_rows[k]] += src[order[k]] from zero;
    with `vrow` (`segment_sum`'s rows of src, checked against it) the sort
    is vrow's own when not given."""
    m, width = (vrow if vrow is not None else order).shape[0], src.shape[1]
    # one allocation: the output, then the kernels' scratch (two partials a
    # segment); the entry zeroes the output with a memset
    out_len = num_rows * width
    buf = torch.empty(out_len + 2 * -(-m // segment_size()) * width, dtype=torch.float32,
                      device=src.device)
    out = buf[:out_len].view(num_rows, width)
    if vrow is not None:
        _validate(out, vrow, src)
    if m == 0:
        return out.zero_()
    if order is None:
        sorted_rows, order = torch.sort(vrow, stable=True)
    err = _fn("meepo_segment_sum", _SUM_ARGS)(
        out.data_ptr(), sorted_rows.data_ptr(), order.data_ptr(), src.data_ptr(),
        out.data_ptr() + 4 * out_len, m, num_rows, width, _build.raw_stream(src.device),
    )
    if err:
        _build.check(_build.load("row_merge_add"), err, "segment_sum")
    row_merge_add.launches += 2  # the walk and the combine pass
    return out


def segment_sum_gather(src: torch.Tensor, order: torch.Tensor, sorted_rows: torch.Tensor,
                       num_rows: int) -> torch.Tensor:
    """[R, W] f32 rows -> [num_rows, W] f32 with out[sorted_rows[k]] +=
    src[order[k]] from zero, for k = 0 .. m - 1 in order: `sorted_rows`
    int32 [m], non-decreasing; `order` int64 [m], rows of `src` in [0, R).
    Rows of `sorted_rows` outside [0, num_rows) are dropped. CPU tensors
    take the plain version, `index_add_` in the order of k: the kernels'
    twin, to the bit where no run of `sorted_rows` spans three segments of
    `segment_size()` positions; CUDA tensors launch the segment sum's
    kernels."""
    if src.dim() != 2 or src.dtype != torch.float32:
        raise ValueError(f"segment_sum_gather: src must be 2-D float32, got "
                         f"{tuple(src.shape)} {src.dtype}")
    if (order.dtype != torch.int64 or sorted_rows.dtype != torch.int32 or order.dim() != 1
            or order.shape != sorted_rows.shape):
        raise ValueError(f"segment_sum_gather: order must be int64 and sorted_rows int32, "
                         f"both 1-D of one length; got {order.dtype} {tuple(order.shape)} "
                         f"and {sorted_rows.dtype} {tuple(sorted_rows.shape)}")
    if not _on_card((src, order, sorted_rows)):
        out = torch.zeros((num_rows, src.shape[1]), dtype=torch.float32)
        keep = (sorted_rows >= 0) & (sorted_rows < num_rows)
        return out.index_add_(0, sorted_rows[keep].long(), src.index_select(0, order[keep]))
    return _segment_sum_card(src, order, sorted_rows, num_rows)


row_merge_add.launches = 0
