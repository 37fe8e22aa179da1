"""The port's int8 `QuantizedTable` and int8 `ScoringService` against the
JAX package's.

Exact: the codes, scales and zeros (the same numpy quantizer), the lookup's
found mask. Within atol 1e-7 x the row's range: dequantized rows (the
dequantizing multiply-add may round differently in XLA and PyTorch).
Scores within rtol 1e-5 / atol 1e-6 (the towers' f32 matmuls). Ids at and
above 2^31: the port answers exactly, the JAX package does not (it holds
ids in int32)."""

import jax
import numpy as np
import pytest
import torch

from meepoembedding_tpu import checkpoint as jckpt
from meepoembedding_tpu.config import ModelConfig as JModelConfig
from meepoembedding_tpu.config import TableConfig as JTableConfig
from meepoembedding_tpu.models.dlrm import DLRM as JDLRM
from meepoembedding_tpu.serving import ScoringService as JScoringService
from meepoembedding_tpu.serving_quant import QuantizedTable as JQuantizedTable
from meepoembedding_tpu.table.runtime import DynamicEmbeddingTable as JTable
from meepoembedding_tpu_torch import ScoringService
from meepoembedding_tpu_torch.config import ModelConfig, TableConfig
from meepoembedding_tpu_torch.serving_quant import QuantizedTable

torch.set_num_threads(1)

TABLE = dict(dim=8, capacity=4096)
MODEL = dict(kind="dlrm", num_dense_features=4, num_sparse_features=3, embedding_dim=8,
             bottom_mlp=(16, 8), top_mlp=(16, 1))


def _distinct_ids(rng, n):
    """n distinct ids below 2^31, in random order."""
    return rng.permutation(np.unique(rng.integers(1, 2**31 - 1, 2 * n)))[:n].astype(np.int64)


def _save(path, ids, rows, step=7, seed=1):
    t = JTable(JTableConfig(**TABLE))
    if len(ids):
        t.assign(ids, rows)
    params = JDLRM(JModelConfig(**MODEL)).init(jax.random.PRNGKey(seed))
    jckpt.save(path, t.spec, [t.shard], step, dense={"params": params})


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("q8") / "ck")
    rng = np.random.default_rng(0)
    ids = _distinct_ids(rng, 1500)
    rows = rng.normal(size=(1500, 8)).astype(np.float32)
    rows[3] = 0.25  # a constant row: scale 1
    _save(path, ids, rows)
    return path, ids


def test_codes_scales_zeros_bit_equal(ckpt):
    path, _ = ckpt
    jq = JQuantizedTable.from_checkpoint(path)
    tq = QuantizedTable.from_checkpoint(path, device="cpu")
    assert len(tq) == len(jq) == 1500 and tq.dim == jq.dim == 8
    np.testing.assert_array_equal(tq.ids.numpy(), np.asarray(jq.ids).astype(np.int64))
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
    np.testing.assert_array_equal(tq.scales.numpy().view(np.int32),
                                  np.asarray(jq.scales).view(np.int32))
    np.testing.assert_array_equal(tq.zeros.numpy().view(np.int32),
                                  np.asarray(jq.zeros).view(np.int32))
    assert tq.nbytes() == 1500 * (8 + 8 + 16)


def test_lookup_matches_jax_below_2_31(ckpt):
    path, ids = ckpt
    jq = JQuantizedTable.from_checkpoint(path)
    tq = QuantizedTable.from_checkpoint(path, device="cpu")
    rng = np.random.default_rng(3)
    query = np.concatenate([rng.choice(ids, 300), rng.integers(2**30, 2**31 - 1, 100),
                            [0, ids.min() - 1, ids.max() + 1]]).astype(np.int64)
    got = tq.lookup(query).numpy()
    want = np.asarray(jq.lookup(query))
    rng_row = (np.asarray(jq.scales) * 255.0).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7 * rng_row)
    absent = ~np.isin(query, ids)
    assert absent.sum() >= 3 and np.all(got[absent] == 0)
    with pytest.raises(ValueError, match="read-only"):
        tq.lookup(query, train=True)


def test_ids_above_2_31_port_exact_jax_not(tmp_path):
    """The reference keeps its ids in int32 (JAX without 64-bit mode): ids
    that differ only above bit 31 collide there. The port keeps int64."""
    ids = np.array([5, 2**32 + 5, 2**40 + 7, 3], np.int64)
    rows = np.arange(32, dtype=np.float32).reshape(4, 8) * np.array([1, -1, 2, 3],
                                                                     np.float32)[:, None]
    tq = QuantizedTable(ids, rows, device="cpu")
    jq = JQuantizedTable(ids, rows)
    query = np.array([5, 2**32 + 5, 2**40 + 7, 3, 2**33 + 5], np.int64)
    got = tq.lookup(query).numpy()
    for j in range(4):  # every id its own row, within range / 510
        err = (rows[j].max() - rows[j].min()) / 510 + 1e-6
        np.testing.assert_allclose(got[j], rows[j], atol=err)
    assert np.all(got[4] == 0)  # absent
    want = np.asarray(jq.lookup(query))
    np.testing.assert_array_equal(np.asarray(jq.ids), [3, 5, 5, 7])  # truncated
    assert np.array_equal(want[1], want[0])  # 2^32 + 5 reads id 5's row
    assert np.any(want[4] != 0)  # the absent 2^33 + 5 reads a row too


def test_int8_scoring_matches_jax(ckpt):
    path, ids = ckpt
    jsvc = JScoringService(path, JTableConfig(**TABLE), JModelConfig(**MODEL), quantize="int8")
    tsvc = ScoringService(path, TableConfig(**TABLE), ModelConfig(**MODEL), quantize="int8",
                          device="cpu")
    assert tsvc.stats() == jsvc.stats()
    rng = np.random.default_rng(5)
    for shape in ((8, 3), (5, 3, 4)):
        known = rng.choice(ids, size=shape)
        unknown = rng.integers(2**30, 2**31 - 1, size=shape)
        req = np.where(rng.random(shape) < 0.8, known, unknown)
        dense = rng.normal(size=(shape[0], 4)).astype(np.float32)
        np.testing.assert_allclose(tsvc.score(dense, req), jsvc.score(dense, req),
                                   rtol=1e-5, atol=1e-6)
    assert "meepo_table_rows 1500" in tsvc.metrics_text()
    assert "meepo_score_latency_ms" in tsvc.metrics_text()


def test_int8_reload_and_empty_checkpoint(ckpt, tmp_path):
    path, ids = ckpt
    tsvc = ScoringService(path, TableConfig(**TABLE), ModelConfig(**MODEL), quantize="int8",
                          device="cpu")
    empty = str(tmp_path / "empty")
    _save(empty, np.zeros((0,), np.int64), np.zeros((0, 8), np.float32), step=9, seed=2)
    jsvc = JScoringService(empty, JTableConfig(**TABLE), JModelConfig(**MODEL), quantize="int8")
    stats = tsvc.reload(empty)
    assert stats == jsvc.stats() and stats["rows"] == 0 and stats["step"] == 9
    dense = np.ones((4, 4), np.float32)
    req = np.tile(ids[:3], (4, 1))
    got = tsvc.score(dense, req)
    np.testing.assert_allclose(got, jsvc.score(dense, req), rtol=1e-5, atol=1e-6)
    assert len(tsvc.table.lookup(ids[:5])) == 5 and not tsvc.table.lookup(ids[:5]).any()
    tsvc.reload(path)
    assert tsvc.stats()["rows"] == 1500
    with pytest.raises(ValueError, match="dim mismatch"):
        ScoringService(path, TableConfig(dim=16, capacity=4096),
                       ModelConfig(**{**MODEL, "embedding_dim": 16, "bottom_mlp": (16, 16)}),
                       quantize="int8", device="cpu")


def test_dim_not_multiple_of_4_on_cpu():
    """Codes of a dim that is no multiple of 4 cannot be gathered as int32
    words: the CPU reads them directly (the card refuses such a table)."""
    rng = np.random.default_rng(2)
    ids = _distinct_ids(rng, 50)
    rows = rng.normal(size=(50, 6)).astype(np.float32)
    tq = QuantizedTable(ids, rows, device="cpu")
    np.testing.assert_array_equal(tq.values.numpy(),
                                  np.asarray(JQuantizedTable(ids, rows).values))
    got = tq.lookup(ids).numpy()
    err = (rows.max(1) - rows.min(1))[:, None] / 510 + 1e-6
    assert np.all(np.abs(got - rows) <= err)
