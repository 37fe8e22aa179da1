"""The port's row kernels against the reference's TPU kernels.

On the CPU the wrappers run their plain PyTorch versions; these are held
bit-exactly against the Pallas kernels in interpret mode: `row_gather` (K2)
and `row_scatter_set` (K4, unique rows) from pallas_ops, and
`stream_merge_set` (K5: duplicate rows with disjoint lanes, dropped rows).
The reference kernels' masked sets are the port's set on the plane's flat
[R * 128, 1] view, one index per masked element, as the port's callers
write the bucket planes.
The CUDA kernels are held against the plain versions on the card by
`test_torch_gpu.py`."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from meepoembedding_tpu.table import pallas_ops
from meepoembedding_tpu.table.stream_merge import BLOCKR, stream_merge_set
from meepoembedding_tpu_torch.kernels import (
    row_gather,
    row_gather_multi,
    row_scatter_add,
    row_scatter_set,
)

torch.set_num_threads(1)

DTYPES = ("int32", "float32", "bfloat16")


def _plane(rng, shape, dtype: str) -> np.ndarray:
    """Random values of `dtype` as numpy (bf16 as ml_dtypes.bfloat16)."""
    if dtype == "int32":
        return rng.integers(-(2**31), 2**31 - 1, size=shape, dtype=np.int32)
    x = rng.normal(size=shape).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flat_set(plane, idx, upd, mask) -> torch.Tensor:
    """The masked set plane[idx[j], l] = upd[j, l] where mask[j, l], through
    the port: one element set on the flat view, index idx[j] * W + l (rows
    outside [0, R) land outside [0, R * W) and are dropped)."""
    W = plane.shape[1]
    j, lane = np.nonzero(mask)
    flat = np.clip(idx[j].astype(np.int64) * W + lane, -1, 2**31 - 1).astype(np.int32)
    got = _to_torch(plane)
    row_scatter_set(got.view(-1, 1), torch.from_numpy(flat), _to_torch(upd[j, lane][:, None]))
    return got


def _bits(x) -> np.ndarray:
    """Raw bits of a torch tensor or numpy/jax array, for exact comparison."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.int32)
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a.view(np.int32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 300, 1000])
def test_row_gather_plain_matches_pallas(dtype, n):
    rng = np.random.default_rng(n)
    R = 512
    plane = _plane(rng, (R, 128), dtype)
    idx = rng.integers(-5, R + 5, size=n).astype(np.int32)  # out of range clamps
    idx[:2] = [-(2**31), 2**31 - 1][: min(2, n)]
    want = pallas_ops.row_gather(jnp.asarray(plane), jnp.asarray(idx), interpret=True)
    before = row_gather.launches
    got = row_gather(_to_torch(plane), torch.from_numpy(idx))
    assert row_gather.launches == before  # CPU tensors never launch the kernel
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("width", [8, 32, 256])
def test_row_gather_plain_any_width(width):
    rng = np.random.default_rng(width)
    plane = torch.from_numpy(_plane(rng, (64, width), "float32"))
    idx = torch.from_numpy(rng.integers(-3, 70, size=100).astype(np.int32))
    got = row_gather(plane, idx)
    np.testing.assert_array_equal(got.numpy(), plane.numpy()[np.clip(idx.numpy(), 0, 63)])


@pytest.mark.parametrize("dtype", DTYPES)
def test_row_scatter_set_plain_matches_pallas_unique_rows(dtype):
    rng = np.random.default_rng(7)
    R, n = 4 * pallas_ops.BLK, 300
    plane = _plane(rng, (R, 128), dtype)
    idx = rng.choice(R, size=n, replace=False).astype(np.int32)
    idx[::7] = -1  # dropped rows (K4 clips idx >= R instead of dropping it)
    upd = _plane(rng, (n, 128), dtype)
    mask = rng.random((n, 128)) < 0.5
    want = pallas_ops.row_scatter_set(jnp.asarray(plane), jnp.asarray(idx),
                                      jnp.asarray(upd), jnp.asarray(mask), interpret=True)
    got = _flat_set(plane, idx, upd, mask)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _dup_rows_case(rng, R, n, dtype):
    """Duplicate rows whose lane masks are disjoint (one-hot lanes, as the
    bucket planes get them), plus rows below 0 and at or beyond R."""
    plane = _plane(rng, (R, 128), dtype)
    idx = rng.integers(0, R // 16, size=n).astype(np.int32)  # many duplicates
    lanes = rng.permutation(np.tile(np.arange(128), -(-n // 128)))[:n]
    # make (row, lane) unique: one lane per duplicate of a row
    seen, keep = set(), np.ones(n, bool)
    for j in range(n):
        keep[j] = (idx[j], lanes[j]) not in seen
        seen.add((idx[j], lanes[j]))
    idx = np.where(keep, idx, -1).astype(np.int32)
    idx[1::11] = R + np.arange(len(idx[1::11]))  # dropped: beyond the plane
    idx[2::13] = -7
    mask = np.zeros((n, 128), bool)
    mask[np.arange(n), lanes] = True
    upd = _plane(rng, (n, 128), dtype)
    return plane, idx, upd, mask


def _reference_set(plane, idx, upd, mask):
    out = plane.copy()
    for j, r in enumerate(idx):
        if 0 <= r < len(plane):
            out[r] = np.where(mask[j], upd[j], out[r])
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_scatter_set_plain_matches_stream_merge_set(dtype):
    rng = np.random.default_rng(8)
    R = 4 * BLOCKR
    plane, idx, upd, mask = _dup_rows_case(rng, R, 1500, dtype)
    # a whole-row update among the one-hot ones, on a row nobody else touches
    idx[0], mask[0] = R - 1, True
    # K5 sums the updates of a row on the MXU, so its contract (as its
    # callers meet it) has updates zero outside their masks
    upd = np.where(mask, upd, np.zeros((), upd.dtype))
    want = stream_merge_set(jnp.asarray(plane), jnp.asarray(idx), jnp.asarray(upd),
                            jnp.asarray(mask), interpret=True)
    got = _flat_set(plane, idx, upd, mask)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(_reference_set(plane, idx, upd, mask)))


def test_row_scatter_set_plain_int32_duplicate_rows():
    """K5 takes f32/bf16 planes only; the int32 key planes get the same
    contract, checked against the element loop."""
    rng = np.random.default_rng(9)
    plane, idx, upd, mask = _dup_rows_case(rng, 1024, 1500, "int32")
    got = _flat_set(plane, idx, upd, mask)
    np.testing.assert_array_equal(got.numpy(), _reference_set(plane, idx, upd, mask))


def test_row_scatter_set_whole_rows_drops_out_of_range():
    rng = np.random.default_rng(10)
    plane = rng.normal(size=(64, 32)).astype(np.float32)
    idx = np.array([3, -1, 64, 70, 10], np.int32)
    upd = rng.normal(size=(5, 32)).astype(np.float32)
    got = row_scatter_set(torch.from_numpy(plane.copy()), torch.from_numpy(idx),
                          torch.from_numpy(upd))
    want = plane.copy()
    want[3], want[10] = upd[0], upd[4]
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_validate_arguments():
    plane = torch.zeros((8, 4), dtype=torch.float32)
    with pytest.raises(ValueError):
        row_scatter_set(plane, torch.zeros(2, dtype=torch.int64), torch.zeros(2, 4))
    with pytest.raises(ValueError):
        row_scatter_set(plane, torch.zeros(2, dtype=torch.int32),
                        torch.zeros(2, 4, dtype=torch.float64))
    with pytest.raises(ValueError):
        row_scatter_set(plane, torch.zeros(2, dtype=torch.int32), torch.zeros(2, 3))
    idx = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):  # no plane, or more than MAX_PLANES
        row_gather_multi([], idx)
    with pytest.raises(ValueError):
        row_gather_multi([plane] * 5, idx)
    with pytest.raises(ValueError):  # mixed row bytes
        row_gather_multi([plane, torch.zeros((8, 5))], idx)
    with pytest.raises(ValueError):  # one shape, mixed element sizes
        row_gather_multi([plane, plane.to(torch.bfloat16)], idx)
    with pytest.raises(ValueError):
        row_gather_multi([plane], idx.long())
    with pytest.raises(ValueError):  # a fetch-add's old of another shape or type
        row_scatter_add(plane, idx, torch.zeros(2, 4), torch.zeros(3, 4))
    with pytest.raises(ValueError):
        row_scatter_add(plane, idx, torch.zeros(2, 4), torch.zeros(2, 4, dtype=torch.int32))
