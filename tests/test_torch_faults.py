"""Faults of the port against the reference, repaired, and one difference
kept on purpose:

- a restore that cannot fit (another dim or optimizer) raises before the
  old planes are dropped, so the table and the trainer keep their rows (the
  reference assigns the shard only after the restore);
- `export_items` yields rows in the values plane's dtype, bit-equal to the
  reference's at f32 and at bf16;
- (kept) a freed slot is cleared by a set, so an id re-inserted there
  reads its init, where the reference's exact subtraction leaves a NaN row
  NaN and the insert adds its init to it.
(`logq_correction` on a model without an in-batch softmax is refused:
`test_torch_zoo.py`.)"""

import ml_dtypes
import numpy as np
import pytest
import torch

from meepoembedding_tpu.config import OptimizerConfig as JOptimizerConfig
from meepoembedding_tpu.config import TableConfig as JTableConfig
from meepoembedding_tpu.table.runtime import DynamicEmbeddingTable as JTable
from meepoembedding_tpu_torch.config import ModelConfig, OptimizerConfig, RunConfig, TableConfig
from meepoembedding_tpu_torch.table import hashing
from meepoembedding_tpu_torch.table.runtime import DynamicEmbeddingTable
from meepoembedding_tpu_torch.train import Trainer

torch.set_num_threads(1)

IDS = np.arange(1, 601, dtype=np.int64) * 7919


def _saved(tmp_path, name, **cfg):
    t = DynamicEmbeddingTable(TableConfig(**cfg), device="cpu")
    t.lookup(IDS, train=True)
    path = str(tmp_path / name)
    t.save(path)
    return path


@pytest.mark.parametrize("other", [dict(dim=16), dict(optimizer=OptimizerConfig(kind="adam"))],
                         ids=["dim", "optimizer"])
def test_failed_restore_keeps_the_table(tmp_path, other):
    # the checkpoint's 600 rows would grow this table (0.1 * 4096 < 600)
    cfg = dict(dim=8, capacity=1 << 12, grow_at_load=0.1)
    path = _saved(tmp_path, "other", **{**cfg, "grow_at_load": None, **other})
    t = DynamicEmbeddingTable(TableConfig(**cfg), device="cpu")
    rows = t.lookup(IDS[:300], train=True)
    spec = t.spec
    with pytest.raises(ValueError, match="mismatch"):
        t.load(path)
    assert t.spec is spec and t.cfg.capacity == 1 << 12  # growth not applied
    assert torch.equal(t.lookup(IDS[:300], train=False), rows)
    assert len(t) == 300


def test_failed_trainer_restore_keeps_the_table(tmp_path):
    path = _saved(tmp_path, "dim16", dim=16, capacity=1 << 12)
    mc = ModelConfig(num_dense_features=2, num_sparse_features=3, embedding_dim=8,
                     bottom_mlp=(8, 8), top_mlp=(8, 1))
    tr = Trainer(RunConfig(), TableConfig(dim=8, capacity=1 << 12), mc, device="cpu")
    batch = {"dense": np.ones((4, 2), np.float32), "ids": IDS[:12].reshape(4, 3),
             "label": np.ones(4, np.float32)}
    tr.train_step(batch)
    before = tr.eval_step(batch)["logits"]
    with pytest.raises(ValueError, match="dim mismatch"):
        tr.load_checkpoint(path)
    assert tr.shard is not None and tr.step == 1
    assert torch.equal(tr.eval_step(batch)["logits"], before)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_items_bit_equal_to_jax(dtype):
    cfg = dict(dim=16, capacity=1 << 12, value_dtype=dtype)
    mine = DynamicEmbeddingTable(TableConfig(**cfg), device="cpu")
    ref = JTable(JTableConfig(**cfg, optimizer=JOptimizerConfig()))
    rows = np.random.default_rng(0).normal(size=(200, 16)).astype(np.float32)
    for t in (mine, ref):
        t.assign(IDS[:200], rows)
        t.lookup(IDS[150:], train=True)  # 100 fresh ids at their init
    got, want = list(mine.export_items(16)), list(ref.export_items(16))
    assert len(got) == len(want) > 1
    for (ids, r, freq, acc), (jids, jr, jfreq, jacc) in zip(got, want):
        np.testing.assert_array_equal(ids, jids)
        assert r.dtype == getattr(torch, dtype)
        if dtype == "bfloat16":
            assert jr.dtype == ml_dtypes.bfloat16
            np.testing.assert_array_equal(r.view(torch.int16).numpy().view(np.uint16),
                                          jr.view(np.uint16))
        else:
            np.testing.assert_array_equal(r.numpy().view(np.uint32), jr.view(np.uint32))
        np.testing.assert_array_equal(freq, jfreq)
        np.testing.assert_array_equal(acc.view(np.uint32), jacc.view(np.uint32))


def test_reinserted_slot_reads_its_init_after_a_nan_row():
    cfg = dict(dim=8, capacity=1 << 10)
    mine = DynamicEmbeddingTable(TableConfig(**cfg), device="cpu")
    ref = JTable(JTableConfig(**cfg))
    ids = IDS[:1]
    nan = np.full((1, 8), np.nan, np.float32)
    for t in (mine, ref):
        t.assign(ids, nan)
        assert t.remove(ids) == 1
        t.lookup(ids, train=True)  # re-inserted into the freed slot
    hi, lo = hashing.split_ids_t(torch.from_numpy(ids))
    init = hashing.default_rows(hi, lo, 8, TableConfig(**cfg).initializer_scale)
    assert torch.equal(mine.lookup(ids, train=False), init)
    assert np.isnan(np.asarray(ref.lookup(ids, train=False))).all()  # the reference's NaN
