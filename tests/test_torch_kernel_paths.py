"""The K1 and K4/K5 paths of the port against the JAX package, on the CPU.

On the CPU every wrapper runs its plain PyTorch version, so these hold the
plain versions and the callers' use of them:

- the unique-row add (`row_merge_add`) against the Pallas
  `stream_merge_add` in interpret mode, on unique rows: f32 bit-exact (one
  add an element in both); bf16 within 2^-7 (|old| + |upd| + |result|),
  since the reference casts the update to bf16 and adds in bf16;
- `unique_pairs`' `order` and `sorted_ids` against a stable sort of its
  `inverse`, without overflow, with `owner_major`, and under overflow;
- `segment_sum_grads` with and without the dedup's sort against the JAX
  dedup backward, within rtol 1e-6 / atol 1e-6 (f32 sums of a few terms,
  in input order on the port's side, in XLA's order on the reference's);
- the multi-plane set's plain version against one `row_scatter_set_plain`
  a plane, bit for bit, with scalar and tensor values on int32, f32 and
  bf16 planes;
- the callers: `lookup_train` sets its four bucket planes in one call, a
  restore or assign batch in three; the Trainer's values updates pass
  unique slots, and its backward passes the dedup's sort.

The CUDA kernels are held against these plain versions on the card by
`test_torch_gpu.py`."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from meepoembedding_tpu.ops import dedup as jdedup
from meepoembedding_tpu.table import hashing as jh
from meepoembedding_tpu.table.stream_merge import BLOCKR, stream_merge_add
from meepoembedding_tpu_torch.config import ModelConfig, OptimizerConfig, RunConfig, TableConfig
from meepoembedding_tpu_torch.kernels import (
    row_merge_add,
    row_scatter_set_multi,
    row_scatter_set_multi_plain,
    row_scatter_set_plain,
    segment_sum,
)
from meepoembedding_tpu_torch.kernels import row_scatter_set as set_wrapper
from meepoembedding_tpu_torch.ops import dedup
from meepoembedding_tpu_torch.table import hashing as th
from meepoembedding_tpu_torch.table import layout as tl
from meepoembedding_tpu_torch.table import table_ops as tx

torch.set_num_threads(1)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


# --- the unique-row add ------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unique_add_plain_matches_stream_merge_add(dtype):
    rng = np.random.default_rng(21)
    R = 4 * BLOCKR
    plane = rng.normal(size=(R, 128)).astype(np.float32)
    if dtype == "bfloat16":
        plane = plane.astype(ml_dtypes.bfloat16)
    vrow = rng.choice(R, size=3000, replace=False).astype(np.int32)
    vrow[1::17] = -1 - np.arange(len(vrow[1::17]))  # dropped
    vrow[2::19] = R + np.arange(len(vrow[2::19]))  # dropped
    upd = rng.normal(size=(3000, 128)).astype(np.float32)
    want = np.asarray(stream_merge_add(jnp.asarray(plane), jnp.asarray(vrow), jnp.asarray(upd),
                                       interpret=True)).astype(np.float32)
    got = (torch.from_numpy(plane.view(np.int16).copy()).view(torch.bfloat16)
           if dtype == "bfloat16" else torch.from_numpy(plane.copy()))
    before = row_merge_add.launches
    row_merge_add(got, torch.from_numpy(vrow), torch.from_numpy(upd))
    assert row_merge_add.launches == before  # CPU tensors never launch the kernel
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
    else:
        old = plane.astype(np.float32)
        ok = (vrow >= 0) & (vrow < R)
        absum = np.abs(old)
        absum[vrow[ok]] += np.abs(upd[ok])
        assert (np.abs(got - want) <= 2.0**-7 * (absum + np.abs(want))).all()
    untouched = np.setdiff1d(np.arange(R), vrow)
    np.testing.assert_array_equal(got[untouched], plane.astype(np.float32)[untouched])


def test_unique_add_is_old_plus_upd_rounded_once():
    """Each valid row gets old + upd in f32, rounded once to the plane's type
    (f32, bf16); the segment sum of the same unique rows is upd itself."""
    rng = np.random.default_rng(22)
    vrow = torch.from_numpy(rng.permutation(600)[:400].astype(np.int32) - 50)
    upd = torch.from_numpy(rng.normal(size=(400, 24)).astype(np.float32))
    ok = (vrow >= 0) & (vrow < 500)
    for dtype in (torch.float32, torch.bfloat16):
        base = torch.from_numpy(rng.normal(size=(500, 24)).astype(np.float32)).to(dtype)
        want = base.clone()
        want[vrow[ok].long()] = (base[vrow[ok].long()].float() + upd[ok]).to(dtype)
        got = row_merge_add(base.clone(), vrow, upd)
        assert torch.equal(_bits(got), _bits(want))
    summed = segment_sum(upd, vrow, 500)
    assert torch.equal(summed[vrow[ok].long()], upd[ok])
    assert int(summed.abs().sum(1).gt(0).sum()) == int(ok.sum())


# --- the dedup's sort -------------------------------------------------------------------

def _ids(seed: int, n: int) -> np.ndarray:
    """Ids with heavy duplication and invalid padding."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(-(2**63), 2**63 - 1, size=max(4, n // 5), dtype=np.int64)
    ids = rng.choice(pool, size=n)
    ids[rng.random(n) < 0.1] = jh.EMPTY_ID
    return ids


def _unique(ids, size, owner_major=0):
    hi, lo = jh.split_ids(ids)
    return dedup.unique_pairs(_t(hi), _t(lo), size, owner_major=owner_major)


@pytest.mark.parametrize("owner_major", [0, 2, 3])
@pytest.mark.parametrize("n", [1, 7, 1024, 4096])
def test_unique_order_is_the_stable_sort_of_inverse(n, owner_major):
    u = _unique(_ids(n, n), n, owner_major)
    want = torch.sort(u.inverse, stable=True)
    assert u.order.dtype == torch.int64 and u.sorted_ids.dtype == torch.int32
    assert torch.equal(u.order, want.indices)
    assert torch.equal(u.sorted_ids, want.values)
    assert torch.equal(u.inverse[u.order], u.sorted_ids)


def test_unique_order_under_overflow():
    """Aliased ids share the last run, in id order rather than input order:
    still a permutation that sorts `inverse`, and the stable sort elsewhere."""
    ids = _ids(31, 2048)
    size = len(np.unique(ids)) // 3
    u = _unique(ids, size)
    assert int(u.inverse.max()) == size - 1
    assert torch.equal(torch.sort(u.order).values, torch.arange(2048))
    assert torch.equal(u.inverse[u.order], u.sorted_ids)
    assert bool((u.sorted_ids[1:] >= u.sorted_ids[:-1]).all())
    stable = torch.sort(u.inverse, stable=True)
    assert torch.equal(u.sorted_ids, stable.values)
    head = u.sorted_ids < size - 1
    assert torch.equal(u.order[head], stable.indices[head])
    assert not torch.equal(u.order, stable.indices)  # the last run is in id order


@pytest.mark.parametrize("case", ["plain", "owner_major", "overflow"])
def test_segment_sum_grads_with_and_without_sort_matches_jax(case):
    n, dim = 3000, 32
    ids = _ids(41, n)
    size = len(np.unique(ids)) // 2 if case == "overflow" else n
    u = _unique(ids, size, 3 if case == "owner_major" else 0)
    grads = np.random.default_rng(42).normal(size=(n, dim)).astype(np.float32)
    want = np.asarray(jdedup.segment_sum_grads(jnp.asarray(grads), jnp.asarray(u.inverse.numpy()),
                                               size))
    sorted_ = dedup.segment_sum_grads(_t(grads), u.inverse, size, u.order, u.sorted_ids)
    unsorted = dedup.segment_sum_grads(_t(grads), u.inverse, size)
    np.testing.assert_allclose(sorted_.numpy(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(sorted_, unsorted)


def test_gather_rows_backward_with_the_dedup_sort():
    u = _unique(_ids(51, 500), 500)
    rng = np.random.default_rng(52)
    rows = torch.from_numpy(rng.normal(size=(500, 8)).astype(np.float32)).requires_grad_(True)
    w = torch.from_numpy(rng.normal(size=(500, 8)).astype(np.float32))
    (dedup.GatherRows.apply(rows, u.inverse, u.order, u.sorted_ids) * w).sum().backward()
    want = torch.zeros(500, 8).index_add_(0, u.inverse.long(), w)
    assert torch.equal(rows.grad, want)


def test_segment_sum_drops_and_validates():
    upd = torch.ones((4, 2))
    out = segment_sum(upd, torch.tensor([0, -1, 3, 9], dtype=torch.int32), 4)
    assert torch.equal(out, torch.tensor([[1.0, 1], [0, 0], [0, 0], [1, 1]]))
    with pytest.raises(ValueError):  # half a sort
        segment_sum(upd, torch.zeros(4, dtype=torch.int32), 4, order=torch.arange(4))
    with pytest.raises(ValueError):  # order must be int64
        segment_sum(upd, torch.zeros(4, dtype=torch.int32), 4,
                    torch.arange(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32))


# --- the multi-plane set ----------------------------------------------------------------

def _plane(rng, shape, dtype):
    if dtype == torch.int32:
        return torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, size=shape, dtype=np.int32))
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("k", [1, 4, 8])
def test_multi_set_plain_equals_one_set_a_plane(k):
    """Flat views of [64, 128] planes, int32 and f32, scalar and tensor
    values, one-hot lanes of duplicate rows and dropped indices."""
    rng = np.random.default_rng(k)
    planes = [_plane(rng, (64, 128), torch.int32 if p % 2 else torch.float32).view(-1, 1)
              for p in range(k)]
    idx = rng.choice(64 * 128, size=500, replace=False).astype(np.int32)
    idx[::13] = -1
    idx[1::17] = 64 * 128 + 5
    idx = torch.from_numpy(idx)
    scalars = [7, -0.25, 2**31 + 5, 1e30, -3, 0.1]
    values = [_plane(rng, (500, 1), p.dtype) if j % 3 == 0 else scalars[j % len(scalars)]
              for j, p in enumerate(planes)]
    got = [p.clone() for p in planes]
    before = set_wrapper.launches
    row_scatter_set_multi(got, idx, values)
    assert set_wrapper.launches == before
    for plane, g, v in zip(planes, got, values):
        want = plane.clone()
        if not isinstance(v, torch.Tensor):  # the scalar as the old callers built it
            v = torch.as_tensor(v).to(plane.dtype).expand(500).reshape(-1, 1).contiguous()
        row_scatter_set_plain(want, idx, v)
        assert torch.equal(_bits(g), _bits(want))


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.bfloat16])
def test_multi_set_whole_rows_with_scalar_rows(dtype):
    rng = np.random.default_rng(3)
    planes = [_plane(rng, (300, 12), dtype) for _ in range(3)]
    idx = torch.from_numpy(rng.permutation(340)[:200].astype(np.int32) - 20)
    values = [_plane(rng, (200, 12), dtype), 0, 1.5 if dtype != torch.int32 else -9]
    got = [p.clone() for p in planes]
    row_scatter_set_multi_plain(got, idx, values)
    for plane, g, v in zip(planes, got, values):
        want = plane.clone()
        if not isinstance(v, torch.Tensor):
            v = torch.full((200, 12), v).to(dtype)
        row_scatter_set_plain(want, idx, v)
        assert torch.equal(_bits(g), _bits(want))


def test_multi_set_refuses_what_one_launch_cannot_do():
    idx = torch.zeros(2, dtype=torch.int32)
    a, b = torch.zeros((8, 1), dtype=torch.int32), torch.zeros((8, 2), dtype=torch.int32)
    with pytest.raises(ValueError):  # two shapes
        row_scatter_set_multi([a, b], idx, [1, 1])
    with pytest.raises(ValueError):  # more than 8 planes
        row_scatter_set_multi([a] * 9, idx, [1] * 9)
    with pytest.raises(ValueError):  # a value neither a number nor [n, W]
        row_scatter_set_multi([a], idx, [torch.zeros(3, 1, dtype=torch.int32)])
    with pytest.raises(ValueError):
        row_scatter_set_multi([a], idx, ["1"])


# --- the callers --------------------------------------------------------------------------

class _Spy:
    """Records the calls a wrapper gets and passes them on."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        return self.fn(*args, **kwargs)


def test_lookup_train_sets_its_planes_in_one_call(monkeypatch):
    spy = _Spy(row_scatter_set_multi)
    monkeypatch.setattr(tx, "row_scatter_set_multi", spy)
    spec = tl.TableSpec.from_config(TableConfig(dim=8, capacity=64 * 128))
    shard = tl.alloc_shard(spec, "cpu")
    u = _unique(_ids(61, 1024), 1024)
    ctx = tx.lookup_train(spec, shard, u.hi, u.lo, u.valid, 3)
    assert len(spy.calls) == 1
    planes, idx, values = spy.calls[0][0]
    assert [p.data_ptr() for p in planes] == [
        x.data_ptr() for x in (shard.key_hi, shard.key_lo, shard.freq, shard.last)]
    assert values[2:] == [1, 3]
    assert torch.equal(idx, torch.where(ctx.fresh, ctx.slot, -1))


@pytest.mark.parametrize("kind, fulldim", [("rowwise_adagrad", 0), ("adam", 2)])
def test_insert_rows_sets_in_three_calls(monkeypatch, kind, fulldim):
    spy = _Spy(row_scatter_set_multi)
    monkeypatch.setattr(tx, "row_scatter_set_multi", spy)
    spec = tl.TableSpec.from_config(TableConfig(dim=8, capacity=64 * 128,
                                                optimizer=OptimizerConfig(kind=kind)))
    shard = tl.alloc_shard(spec, "cpu")
    assert len(shard.opt_fulldim) == fulldim
    hi, lo = jh.split_ids(np.unique(_ids(62, 700)))
    rows = torch.from_numpy(np.random.default_rng(5).normal(size=(len(hi), 8)).astype(np.float32))
    valid = th.is_valid(_t(hi), _t(lo))
    ok = tx.insert_rows(spec, shard, _t(hi), _t(lo), rows, valid, 4)
    assert bool(ok[valid].all())
    assert [len(c[0][0]) for c in spy.calls] == [2, 3 if kind == "rowwise_adagrad" else 2,
                                               1 + fulldim]


def test_trainer_updates_unique_slots_and_reuses_the_dedup_sort(monkeypatch):
    """The uniqueness contract of the values update, on the Trainer's real
    slots, and the segment sum fed with the dedup's sort."""
    from meepoembedding_tpu_torch.data import SyntheticConfig, SyntheticStream
    from meepoembedding_tpu_torch.train import Trainer

    merges, sums = _Spy(tx.row_merge_add), _Spy(segment_sum)
    monkeypatch.setattr(tx, "row_merge_add", merges)
    monkeypatch.setattr(dedup, "segment_sum", sums)
    mc = ModelConfig(num_dense_features=4, num_sparse_features=3, embedding_dim=16,
                     bottom_mlp=(32, 16), top_mlp=(32, 1))
    tr = Trainer(RunConfig(batch_size=256), TableConfig(dim=16, capacity=1 << 14), mc,
                 device="cpu")
    for b in SyntheticStream(SyntheticConfig(num_dense=4, num_sparse=3, batch_size=256,
                                             seed=7)).batches(3):
        tr.train_step(b)
    assert len(merges.calls) == 3 and len(sums.calls) == 3
    for (plane, idx, upd), kwargs in merges.calls:
        assert kwargs == {}
        valid = idx[idx >= 0]
        assert valid.numel() > 0 and torch.unique(valid).numel() == valid.numel()
    for args, kwargs in sums.calls:
        assert kwargs["order"] is not None and kwargs["sorted_rows"] is not None
        vrow = args[1]
        assert torch.equal(vrow[kwargs["order"]], kwargs["sorted_rows"])
