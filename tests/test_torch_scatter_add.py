"""The port's add kernels against the reference's TPU kernels, on the CPU.

On the CPU the wrappers run their plain PyTorch versions; these are held
against the Pallas kernels in interpret mode:

- `row_scatter_add` (K3, `pallas_ops.row_scatter_add`): unique rows, int32
  and f32, rows below 0 dropped. Exact: one add per element.
- `row_merge_add_plain`, the plain version of K1's two wrappers (the
  unique-row add and the segment sum), against
  `stream_merge.stream_merge_add` at [8192, 128], the
  smallest plane the reference sends through its kernel: duplicate rows,
  rows below 0 and at or beyond R dropped, f32 and bf16 planes. The
  reference sums a row's updates in a one-hot matmul and, on a bf16 plane,
  casts them to bf16 first and adds in bf16; the port sums in f32 in input
  order and rounds once. Tolerance, per element of a row with k updates:
  on f32 planes the bound of two summation orders, 2 (k + 1) 2^-24
  (|old| + sum |upd|); on bf16 planes 2^-7 (|old| + sum |upd| + |result|),
  which covers the reference's rounding of every update and of the sum to
  bf16.

The CUDA kernels are held against the plain versions on the card by
`test_torch_gpu.py`."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from meepoembedding_tpu.table import pallas_ops
from meepoembedding_tpu.table.stream_merge import BLOCKR, stream_merge_add
from meepoembedding_tpu_torch.kernels import row_merge_add_plain, row_scatter_add

torch.set_num_threads(1)


def _plane(rng, shape, dtype: str) -> np.ndarray:
    if dtype == "int32":
        return rng.integers(-(2**31), 2**31 - 1, size=shape, dtype=np.int32)
    x = rng.normal(size=shape).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _to_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("n", [1, 300, 1000])
def test_row_scatter_add_plain_matches_pallas(dtype, n):
    rng = np.random.default_rng(n)
    R = 4 * pallas_ops.BLK
    plane = _plane(rng, (R, 128), dtype)
    idx = rng.choice(R, size=n, replace=False).astype(np.int32)
    idx[::7] = -1 - np.arange(len(idx[::7]))  # dropped rows
    upd = _plane(rng, (n, 128), dtype)
    want = pallas_ops.row_scatter_add(jnp.asarray(plane), jnp.asarray(idx),
                                      jnp.asarray(upd), interpret=True)
    got = _to_torch(plane)
    before = row_scatter_add.launches
    row_scatter_add(got, torch.from_numpy(idx), _to_torch(upd))
    assert row_scatter_add.launches == before  # CPU tensors never launch the kernel
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))  # int32 wraps in both


def test_row_scatter_add_drops_rows_beyond_the_plane():
    """K3 clips idx >= R onto row R - 1 (a quirk no caller relies on); the
    port drops such rows, as the callers' `mode="drop"` means."""
    plane = torch.zeros((16, 4), dtype=torch.int32)
    idx = torch.tensor([3, 16, 2**31 - 1, -1], dtype=torch.int32)
    upd = torch.ones((4, 4), dtype=torch.int32)
    row_scatter_add(plane, idx, upd)
    want = torch.zeros((16, 4), dtype=torch.int32)
    want[3] = 1
    assert torch.equal(plane, want)


def test_row_scatter_add_flat_view_is_an_element_add():
    """The bucket-plane add: one element per slot on the [nb * 128, 1] view."""
    rng = np.random.default_rng(3)
    plane = _plane(rng, (8, 128), "float32")
    slot = rng.choice(8 * 128, size=200, replace=False).astype(np.int32)
    val = rng.random(200).astype(np.float32)
    got = _to_torch(plane)
    row_scatter_add(got.view(-1, 1), torch.from_numpy(slot), torch.from_numpy(val[:, None]))
    want = plane.copy().reshape(-1)
    want[slot] += val
    np.testing.assert_array_equal(got.numpy().reshape(-1), want)


def _merge_case(rng, dtype):
    R, m = 4 * BLOCKR, 3000
    plane = _plane(rng, (R, 128), dtype)
    vrow = rng.integers(0, R // 64, size=m).astype(np.int32)  # ~23 updates a row
    vrow[::5] = rng.integers(0, R, size=len(vrow[::5]))  # and rows seen once
    vrow[1::17] = -1 - np.arange(len(vrow[1::17]))
    vrow[2::19] = R + np.arange(len(vrow[2::19]))
    upd = rng.normal(size=(m, 128)).astype(np.float32)
    return plane, vrow, upd


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_merge_add_plain_matches_stream_merge_add(dtype):
    rng = np.random.default_rng(11)
    plane, vrow, upd = _merge_case(rng, dtype)
    want = stream_merge_add(jnp.asarray(plane), jnp.asarray(vrow), jnp.asarray(upd),
                            interpret=True)
    got = _to_torch(plane)
    row_merge_add_plain(got, torch.from_numpy(vrow), torch.from_numpy(upd))
    ok = (vrow >= 0) & (vrow < plane.shape[0])
    absum = np.abs(_to_f32(plane))
    np.add.at(absum, vrow[ok], np.abs(upd[ok]))
    k = np.bincount(vrow[ok], minlength=plane.shape[0])[:, None]
    if dtype == "float32":
        bound = 2 * (k + 1) * 2.0**-24 * absum
    else:
        bound = 2.0**-7 * (absum + np.abs(_to_f32(want)))
    err = np.abs(_to_f32(got) - _to_f32(want))
    assert (err <= bound).all(), f"max excess {(err - bound).max()}"
    # rows no update reaches keep their bits
    untouched = np.setdiff1d(np.arange(plane.shape[0]), vrow)
    np.testing.assert_array_equal(_to_f32(got)[untouched], _to_f32(plane)[untouched])


def test_row_merge_add_plain_sums_in_input_order():
    """The plain version's sum is old + upd[j0] + upd[j1] + ... in input
    order, in f32, rounded once: the order the kernel sums in."""
    rng = np.random.default_rng(5)
    plane = rng.normal(size=(4, 3)).astype(np.float32)
    vrow = np.array([2, 0, 2, 2, 5, -1, 0], np.int32)
    upd = rng.normal(size=(7, 3)).astype(np.float32)
    want = plane.copy()
    for j, r in enumerate(vrow):
        if 0 <= r < 4:
            want[r] = want[r] + upd[j]
    got = torch.from_numpy(plane.copy())
    row_merge_add_plain(got, torch.from_numpy(vrow), torch.from_numpy(upd))
    np.testing.assert_array_equal(got.numpy(), want)
    # on a bf16 plane: the f32 sum rounded once
    pb = torch.from_numpy(plane).to(torch.bfloat16)
    row_merge_add_plain(pb, torch.from_numpy(vrow), torch.from_numpy(upd))
    wb = torch.from_numpy(plane).to(torch.bfloat16).float().numpy()
    for j, r in enumerate(vrow):
        if 0 <= r < 4:
            wb[r] = wb[r] + upd[j]
    assert torch.equal(pb, torch.from_numpy(wb).to(torch.bfloat16))
