"""The K2 and K3 paths of the port against the JAX package, on the CPU.

On the CPU every wrapper runs its plain PyTorch version, so these hold the
plain versions and the callers' use of them:

- the multi-plane gather's plain version against one `row_gather_plain` a
  plane, and against the Pallas `row_gather` in interpret mode on 128-lane
  planes: bit-exact (a gather copies bits);
- the fetch-add (`row_scatter_add` with `old`) against the Pallas
  `row_scatter_add` in interpret mode, int32 (wrapping) and f32: the plane
  bit-exact (one add an element in both), `old` equal to the Pallas
  `row_gather` of the kept rows and 0 on dropped rows;
- the callers: `probe` (on the CPU, `bucket_probe_plain`) gathers both key
  planes in one call a round group,
  `plan_insert` in one call a round (counted by its `meepo.table.plan_round`
  spans under the profiler), and
  a Trainer step adds to the rowwise accumulator in one fetch-add with no
  gather of it.

The CUDA kernels are held against these plain versions on the card by
`test_torch_gpu.py`."""

import importlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from meepoembedding_tpu.table import hashing as jh
from meepoembedding_tpu.table import pallas_ops
from meepoembedding_tpu_torch.config import ModelConfig, RunConfig, TableConfig
from meepoembedding_tpu_torch.kernels import (
    row_gather,
    row_gather_multi,
    row_gather_plain,
    row_scatter_add,
)
from meepoembedding_tpu_torch.table import layout as tl
from meepoembedding_tpu_torch.table import table_ops as tx

# the module of the probe's plain version, whose gathers the spies count
# (the package's `bucket_probe` attribute is the wrapper function)
bp = importlib.import_module("meepoembedding_tpu_torch.kernels.bucket_probe")

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


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16 if x.element_size() == 2 else torch.int32).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a.view(np.int32)


# --- the multi-plane gather ---------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("width", [1, 32, 256])
def test_gather_multi_plain_is_one_gather_a_plane(k, width):
    """Planes of one shape and element size (int32 and f32 mixed, or bf16),
    indices below 0 and at or beyond R clamped."""
    rng = np.random.default_rng(10 * k + width)
    R, n = 700, 301
    idx = torch.from_numpy(rng.integers(-9, R + 9, size=n).astype(np.int32))
    for dtypes in (("int32", "float32"), ("bfloat16",)):
        planes = [_to_torch(_plane(rng, (R, width), dtypes[p % len(dtypes)])) for p in range(k)]
        before = row_gather.launches
        got = row_gather_multi(planes, idx)
        assert row_gather.launches == before  # CPU tensors never launch the kernel
        assert len(got) == k
        for plane, g in zip(planes, got):
            assert g.dtype == plane.dtype
            np.testing.assert_array_equal(_bits(g), _bits(row_gather_plain(plane, idx)))


@pytest.mark.parametrize("dtypes", [("int32", "float32"), ("bfloat16", "bfloat16")])
def test_gather_multi_matches_pallas(dtypes):
    rng = np.random.default_rng(len(dtypes[0]))
    R, n = 512, 300
    planes = [_plane(rng, (R, 128), d) for d in dtypes]
    idx = rng.integers(-5, R + 5, size=n).astype(np.int32)
    idx[:2] = [-(2**31), 2**31 - 1]
    got = row_gather_multi([_to_torch(p) for p in planes], torch.from_numpy(idx))
    for plane, g in zip(planes, got):
        want = pallas_ops.row_gather(jnp.asarray(plane), jnp.asarray(idx), interpret=True)
        np.testing.assert_array_equal(_bits(g), _bits(want))


# --- the fetch-add ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_fetch_add_plain_matches_pallas(dtype):
    """Unique rows, some below 0 and some at or beyond R (dropped: the
    reference clips idx >= R onto row R - 1, so it gets -1 for those)."""
    rng = np.random.default_rng(3 if dtype == "int32" else 4)
    R, n = 4 * pallas_ops.BLK, 300
    plane = _plane(rng, (R, 128), dtype)
    idx = rng.choice(R + 40, size=n, replace=False).astype(np.int32) - 20
    upd = _plane(rng, (n, 128), dtype)
    kept = (idx >= 0) & (idx < R)
    jidx = np.where(kept, idx, -1).astype(np.int32)
    want = pallas_ops.row_scatter_add(jnp.asarray(plane), jnp.asarray(jidx), jnp.asarray(upd),
                                      interpret=True)
    want_old = np.asarray(pallas_ops.row_gather(jnp.asarray(plane), jnp.asarray(idx),
                                                interpret=True))
    want_old = np.where(kept[:, None], want_old, np.zeros((), want_old.dtype))
    got = _to_torch(plane)
    old = torch.full((n, 128), 7, dtype=got.dtype)  # every element is written
    before = row_scatter_add.launches
    row_scatter_add(got, torch.from_numpy(idx), _to_torch(upd), old)
    assert row_scatter_add.launches == before
    np.testing.assert_array_equal(_bits(got), _bits(np.asarray(want)))  # int32 wraps in both
    np.testing.assert_array_equal(_bits(old), _bits(want_old))
    assert kept.sum() < n and not old.numpy()[~kept].any()


def test_fetch_add_on_the_flat_view_returns_the_old_elements():
    """The accumulator's fetch-add: one element a slot of the [nb * 128, 1]
    view, a wrapping int32 add on freq, 0 for disabled slots."""
    rng = np.random.default_rng(5)
    for dtype, val in ((torch.float32, rng.random(200).astype(np.float32)),
                       (torch.int32, np.full(200, 2**31 - 1, np.int32))):
        plane = _to_torch(_plane(rng, (8, 128), "int32" if dtype == torch.int32 else "float32"))
        slot = torch.from_numpy(rng.choice(8 * 128, size=200, replace=False).astype(np.int32))
        enabled = torch.from_numpy(rng.random(200) < 0.8)
        want = plane.clone().view(-1)
        sel = slot[enabled].long()
        want_old = torch.where(enabled, want[slot.long()], torch.zeros((), dtype=dtype))
        want[sel] += torch.from_numpy(val)[enabled]
        got_old = tx.fetch_add_bucket_plane(plane, slot, torch.from_numpy(val), enabled)
        assert torch.equal(plane.view(-1), want)
        assert torch.equal(got_old, want_old)


# --- the callers ---------------------------------------------------------------------------

class _Spy:
    """Records the calls a wrapper gets and passes them on."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        return self.fn(*args, **kwargs)


def _keys(seed: int, n: int):
    rng = np.random.default_rng(seed)
    hi, lo = jh.split_ids(np.unique(rng.integers(-(2**63), 2**63 - 1, size=n, dtype=np.int64)))
    return torch.from_numpy(np.asarray(hi)), torch.from_numpy(np.asarray(lo))


@pytest.mark.parametrize("rounds", [3, 4])
def test_probe_gathers_both_key_planes_once_a_round_group(monkeypatch, rounds):
    spy = _Spy(row_gather_multi)
    monkeypatch.setattr(bp, "row_gather_multi", spy)
    spec = tl.TableSpec.from_config(TableConfig(dim=8, capacity=32 * 128,
                                                max_probe_rounds=rounds))
    shard = tl.alloc_shard(spec, "cpu")
    hi, lo = _keys(1, 500)
    tx.probe(spec, shard, hi, lo, torch.ones(hi.shape, dtype=torch.bool))
    assert len(spy.calls) == (rounds + 1) // 2
    for (planes, idx), _ in spy.calls:
        assert [p.data_ptr() for p in planes] == [shard.key_hi.data_ptr(),
                                                  shard.key_lo.data_ptr()]
        assert tuple(planes[0].shape) == (spec.num_buckets // 2, 256)


def _plan_rounds(fn):
    """(fn(), the insert-planning rounds it ran): its `meepo.table.plan_round`
    spans under the profiler."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, sum(e.name == "meepo.table.plan_round" for e in prof.events())


def test_plan_insert_gathers_both_key_planes_once_a_round(monkeypatch):
    """A 16-bucket table asked to place 1,900 keys: buckets overflow, so
    planning takes several rounds, each one gather."""
    spy = _Spy(row_gather_multi)
    monkeypatch.setattr(tx, "row_gather_multi", spy)
    spec = tl.TableSpec.from_config(TableConfig(dim=8, capacity=16 * 128, max_probe_rounds=4))
    shard = tl.alloc_shard(spec, "cpu")
    hi, lo = _keys(2, 1900)
    plan, rounds = _plan_rounds(
        lambda: tx.plan_insert(spec, shard, hi, lo, torch.ones(hi.shape, dtype=torch.bool)))
    assert rounds >= 2 and len(spy.calls) == rounds
    assert int(plan.ok.sum()) > 0
    for (planes, idx), _ in spy.calls:
        assert [p.data_ptr() for p in planes] == [shard.key_hi.data_ptr(),
                                                  shard.key_lo.data_ptr()]


def test_train_step_fetch_adds_the_accumulator_without_a_gather(monkeypatch):
    """One rowwise-AdaGrad Trainer step: one row_scatter_add, a fetch-add on
    the accumulator's flat view with `old`; no gather of the accumulator;
    the table's gathers are the probe's, planning's and the values read."""
    from meepoembedding_tpu_torch.data import SyntheticConfig, SyntheticStream
    from meepoembedding_tpu_torch.train import Trainer

    adds, gathers = _Spy(tx.row_scatter_add), _Spy(row_gather_multi)
    monkeypatch.setattr(tx, "row_scatter_add", adds)
    monkeypatch.setattr(tx, "row_gather_multi", gathers)
    monkeypatch.setattr(bp, "row_gather_multi", gathers)
    mc = ModelConfig(num_dense_features=4, num_sparse_features=3, embedding_dim=8,
                     bottom_mlp=(16, 8), top_mlp=(16, 1))
    tr = Trainer(RunConfig(batch_size=64), TableConfig(dim=8, capacity=1 << 12), mc,
                 device="cpu")
    batch = next(iter(SyntheticStream(SyntheticConfig(num_dense=4, num_sparse=3, batch_size=64,
                                                      seed=9)).batches(1)))
    _, rounds = _plan_rounds(lambda: tr.train_step(batch))
    accum = tr.shard.opt_rowwise[0]
    assert len(adds.calls) == 1
    (plane, idx, upd, old), _ = adds.calls[0]
    assert plane.data_ptr() == accum.data_ptr() and tuple(plane.shape) == (accum.numel(), 1)
    assert old is not None and tuple(old.shape) == (idx.shape[0], 1)
    # the table's gathers: the probe's 2 round groups, 1 a planning round, the values
    assert len(gathers.calls) == 2 + rounds + 1
    for (planes, _), _ in gathers.calls:
        assert all(p.data_ptr() != accum.data_ptr() for p in planes)
