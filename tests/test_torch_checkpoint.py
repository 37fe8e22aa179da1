"""Checkpoints written by the JAX package restore into the port bit-exactly.

Restore rehashes rows batch by batch, so the port's planes must equal the
JAX restore's plane for plane, and each live slot's values must equal the
JAX `gather_values` of that slot, for f32 and bf16 (raw-bit) payloads in
streamed part files. The reader also merges the legacy single-file and the
column-sharded layouts exactly as the reference does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meepoembedding_tpu import checkpoint as jckpt
from meepoembedding_tpu.config import OptimizerConfig as JOptimizerConfig
from meepoembedding_tpu.config import TableConfig as JTableConfig
from meepoembedding_tpu.table import layout as jl
from meepoembedding_tpu.table import xla_ops as jx
from meepoembedding_tpu.table.runtime import DynamicEmbeddingTable as JTable
from meepoembedding_tpu_torch import checkpoint as tckpt
from meepoembedding_tpu_torch.config import OptimizerConfig, TableConfig
from meepoembedding_tpu_torch.table import layout as tl
from meepoembedding_tpu_torch.table.runtime import DynamicEmbeddingTable

torch.set_num_threads(1)


def _jax_table(value_dtype="float32", dim=8, n=3000, seed=0, step=7, opt="rowwise_adagrad"):
    cfg = dict(dim=dim, capacity=4096, value_dtype=value_dtype)
    t = JTable(JTableConfig(**cfg, optimizer=JOptimizerConfig(kind=opt)))
    rng = np.random.default_rng(seed)
    ids = rng.integers(-(2**63), 2**63 - 1, size=n, dtype=np.int64)
    t.assign(ids, rng.normal(size=(n, dim)).astype(np.float32))
    t.step = step
    return t, cfg, ids


@pytest.mark.parametrize("value_dtype,opt", [
    ("float32", "rowwise_adagrad"), ("bfloat16", "rowwise_adagrad"), ("float32", "adam"),
])
def test_jax_checkpoint_restores_bit_exact(tmp_path, monkeypatch, value_dtype, opt):
    monkeypatch.setenv("MEEPO_CKPT_CHUNK_ROWS", "1000")  # several part files
    jt, cfg, ids = _jax_table(value_dtype, opt=opt)
    path = str(tmp_path / "ck")
    jt.save(path)
    m = tckpt.read_manifest(path)
    assert len(tckpt._shard_files(tckpt._data_dir(path, m), 0)) == 3

    jspec = jl.TableSpec.from_config(JTableConfig(**cfg, optimizer=JOptimizerConfig(kind=opt)))
    tspec = tl.TableSpec.from_config(TableConfig(**cfg, optimizer=OptimizerConfig(kind=opt)))
    (jshard,), _ = jckpt.restore_shards(jspec, path, 1)
    (tshard,), tm = tckpt.restore_shards(tspec, path, 1, device="cpu")
    assert tm["step"] == 7
    for name in ("key_hi", "key_lo", "cnt", "ovf", "freq", "last", "counters"):
        np.testing.assert_array_equal(
            getattr(tshard, name).numpy(), np.asarray(getattr(jshard, name)), err_msg=name
        )
    assert len(tshard.opt_rowwise) == len(jshard.opt_rowwise)
    for t, j in zip(tshard.opt_rowwise, jshard.opt_rowwise):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    live = np.nonzero(np.asarray(jl.live_mask(jshard)).reshape(-1))[0].astype(np.int32)
    assert len(live) == len(ids)
    assert len(tshard.opt_fulldim) == len(jshard.opt_fulldim)
    for t, j in [(tshard.values, jshard.values), *zip(tshard.opt_fulldim, jshard.opt_fulldim)]:
        want = np.asarray(jx.gather_values(jspec, j, jnp.asarray(live)))
        got = t[torch.from_numpy(live).long()]
        if value_dtype == "bfloat16":
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_table_load_matches_jax_table(tmp_path):
    jt, cfg, ids = _jax_table()
    path = str(tmp_path / "ck")
    jt.save(path)
    j2 = JTable(JTableConfig(**cfg))
    j2.load(path)
    t = DynamicEmbeddingTable(TableConfig(**cfg), device="cpu")
    m = t.load(path)
    assert m["step"] == t.step == j2.step
    assert len(t) == len(j2) == len(ids)
    assert t.counters() == {k: v for k, v in j2.counters().items() if k in t.counters()}
    assert t.load_factor == pytest.approx(j2.load_factor)
    q = np.concatenate([ids[:100], np.arange(1, 50, dtype=np.int64)])
    np.testing.assert_array_equal(t.lookup(q, train=False).numpy(),
                                  np.asarray(j2.lookup(q, train=False)))


def test_restore_too_small_raises(tmp_path):
    jt, cfg, _ = _jax_table()
    path = str(tmp_path / "ck")
    jt.save(path)
    small = tl.TableSpec.from_config(TableConfig(dim=8, capacity=1024))
    with pytest.raises(RuntimeError, match="restore dropped"):
        tckpt.restore_shards(small, path, 1, device="cpu")


def _assert_rows_equal(path):
    want = list(jckpt.iter_rows(path))
    got = list(tckpt.iter_rows(path))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_iter_rows_legacy_single_file(tmp_path):
    jt, _, _ = _jax_table(n=500)
    path = str(tmp_path / "ck")
    saver = jckpt.AsyncCheckpointer()  # writes the single-file shard layout
    saver.save(path, jt.spec, [jt.shard], step=3)
    saver.wait()
    assert tckpt._shard_files(tckpt._data_dir(path, tckpt.read_manifest(path)), 0)[0].endswith(
        "shard-00000.npz")
    _assert_rows_equal(path)


def test_iter_rows_column_sharded(tmp_path):
    """Two column blocks of dim 4 (tables filled identically, so their
    exports run in lockstep) merge into dim-8 rows."""
    cols = [_jax_table(dim=4, n=400, seed=0)[0], _jax_table(dim=4, n=400, seed=0)[0]]
    path = str(tmp_path / "ck")
    jckpt.save_sharded2d(path, cols[0].spec, 8, {(0, 0): cols[0].shard, (0, 1): cols[1].shard},
                         num_shards=1, num_cols=2, step=1)
    _assert_rows_equal(path)
