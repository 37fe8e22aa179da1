"""The port's tiering (eviction spill and promotion) against the JAX
package's, on the CPU.

- `SpillCodec` packs and unpacks as the JAX one does, bit for bit.
- A Trainer with an LFU/TTL policy, a rotating evict window that does not
  divide the buckets and a spill tier, against the JAX Trainer over a few
  steps with `maintenance()` every other step: the evictions of each tick,
  the counters and the integer planes equal exactly; the spilled keys
  equal and their payloads (values, freq, accumulator) within the
  tolerances of `_torch_train_parity.py` (the trained floats differ in
  summation order).
- The evict -> spill -> promote round trip on the host, python, disk and
  redis (`tests/fake_resp.py`) backends brings every trained row back bit
  for bit, and the promoted rows leave the cold tier; the rotating window
  sweeps the table (and wraps at a K that does not divide nb); a promotion
  into a full table re-spills what does not land."""

import jax
import numpy as np
import pytest
import torch
from _torch_train_parity import TOL, assert_planes_equal, assert_tables_match, jax_step
from fake_resp import FakeRespServer

from meepoembedding_tpu.backends import make_backend as jmake_backend
from meepoembedding_tpu.config import ModelConfig as JModelConfig
from meepoembedding_tpu.config import OptimizerConfig as JOptimizerConfig
from meepoembedding_tpu.config import PolicyConfig as JPolicyConfig
from meepoembedding_tpu.config import RunConfig as JRunConfig
from meepoembedding_tpu.config import TableConfig as JTableConfig
from meepoembedding_tpu.data.synthetic import SyntheticConfig, SyntheticStream
from meepoembedding_tpu.table.layout import TableSpec as JTableSpec
from meepoembedding_tpu.table.runtime import DynamicEmbeddingTable as JTable
from meepoembedding_tpu.tiering import SpillCodec as JSpillCodec
from meepoembedding_tpu.train import Trainer as JTrainer
from meepoembedding_tpu.train import _counters as jax_trainer_counters
from meepoembedding_tpu_torch.backends import make_backend
from meepoembedding_tpu_torch.checkpoint import export_shard_arrays
from meepoembedding_tpu_torch.config import (
    ModelConfig,
    OptimizerConfig,
    PolicyConfig,
    RunConfig,
    TableConfig,
)
from meepoembedding_tpu_torch.table.layout import TableSpec
from meepoembedding_tpu_torch.table.runtime import DynamicEmbeddingTable
from meepoembedding_tpu_torch.tiering import SpillCodec
from meepoembedding_tpu_torch.train import Trainer
from meepoembedding_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)


@pytest.mark.parametrize("kind", ["rowwise_adagrad", "adam", "sgd"])
def test_spill_codec_matches_jax(kind):
    table = dict(dim=16, capacity=1 << 12)
    codec = SpillCodec(TableSpec.from_config(TableConfig(**table,
                                                         optimizer=OptimizerConfig(kind=kind))))
    jcodec = JSpillCodec(JTableSpec.from_config(JTableConfig(
        **table, optimizer=JOptimizerConfig(kind=kind))))
    assert codec.width == jcodec.width
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(5, 16)).astype(np.float32)
    freq = rng.integers(1, 100, size=5).astype(np.int32)
    accum = rng.random(5).astype(np.float32)
    full = tuple(rng.normal(size=(5, 16)).astype(np.float32) for _ in range(codec.n_full))
    for args in ((rows, freq, accum, full), (rows, freq)):
        got, want = codec.pack(*args), jcodec.pack(*args)
        np.testing.assert_array_equal(got, want)
        a, b = codec.unpack(got), jcodec.unpack(want)
        assert sorted(a) == sorted(b)
        for k in ("values", "freq", "accum"):
            if k in b:
                np.testing.assert_array_equal(a[k], b[k])
        for x, y in zip(a["fulldim"], b["fulldim"], strict=True):
            np.testing.assert_array_equal(x, y)


def _trainer_configs():
    table = dict(dim=8, capacity=16 * 128, max_probe_rounds=2)
    policy = dict(evict_policy="lfu_ttl", ttl_steps=2, lfu_min_freq=2, max_evict_per_pass=96,
                  evict_scan_buckets=5)
    model = dict(num_dense_features=4, num_sparse_features=3, embedding_dim=8,
                 bottom_mlp=(16, 8), top_mlp=(16, 1))
    run = dict(batch_size=96, steps=8, seed=4, dense_learning_rate=1e-3)
    j = (JRunConfig(**run), JTableConfig(**table, policy=JPolicyConfig(**policy)),
         JModelConfig(**model))
    t = (RunConfig(**run), TableConfig(**table, policy=PolicyConfig(**policy)),
         ModelConfig(**model))
    return j, t


def _store(b) -> dict:
    return {int(k): r for keys, rows in b.export() for k, r in zip(keys, rows)}


def test_trainer_maintenance_with_spill_matches_jax():
    (jrc, jtc, jmc), (rc, tc, mc) = _trainer_configs()
    jspill = jmake_backend("python", width=JSpillCodec(JTableSpec.from_config(jtc)).width)
    tspill = make_backend("python", width=SpillCodec(TableSpec.from_config(tc)).width)
    jt = JTrainer(jrc, jtc, jmc, spill=jspill)
    tt = Trainer(rc, tc, mc, device="cpu", spill=tspill)
    from_jax_params(tt.model, jax.tree_util.tree_map(np.asarray, jt.params))
    data = dict(num_dense=4, num_sparse=3, batch_size=96, vocab_per_feature=500, seed=3)
    evicted = []
    for i, batch in enumerate(SyntheticStream(SyntheticConfig(**data)).batches(rc.steps)):
        jloss, _ = jax_step(jt, batch)
        np.testing.assert_allclose(tt.train_step(batch)["loss"], jloss, **TOL)
        if i % 2 == 1:
            jn, tn = jt.maintenance()["evicted"], tt.maintenance()["evicted"]
            assert tn == jn
            evicted.append(tn)
            assert tt._evict_cursor == jt._evict_cursor
    assert sum(evicted) > 0 and len(tspill) == len(jspill) > 0
    jc = jax_trainer_counters(jt)
    assert tt.counters() == jc
    assert jc["spills"] == sum(evicted) and jc["evictions"] == sum(evicted)
    assert_tables_match(jt.spec, jt.shard, tt.shard)
    a, b = _store(tspill), _store(jspill)
    assert sorted(a) == sorted(b)
    got, want = np.stack([a[k] for k in sorted(a)]), np.stack([b[k] for k in sorted(b)])
    np.testing.assert_array_equal(got[:, 8], want[:, 8])  # freq
    np.testing.assert_allclose(got, want, **TOL)


def _cfg(kind="rowwise_adagrad", ttl=5, capacity=1 << 12, **policy):
    return TableConfig(
        dim=16, capacity=capacity, optimizer=OptimizerConfig(kind=kind, learning_rate=0.05),
        policy=PolicyConfig(evict_policy=policy.pop("evict_policy", "ttl"), ttl_steps=ttl,
                            max_evict_per_pass=1 << 10, **policy))


def _state(t) -> dict:
    arrs = export_shard_arrays(t.spec, t.shard)
    return {int(k): {n: arrs[n][j].copy() for n in arrs if n != "ids"}
            for j, k in enumerate(arrs["ids"])}


@pytest.mark.parametrize("backend_kind,kind", [
    ("host", "rowwise_adagrad"), ("python", "rowwise_adagrad"), ("disk", "rowwise_adagrad"),
    ("redis", "rowwise_adagrad"), ("python", "adam"),
])
def test_evict_spill_promote_roundtrip(backend_kind, kind, tmp_path):
    """Train rows, age them out past the TTL into the cold tier, touch them
    again: their value, freq and optimizer state come back bit for bit."""
    cfg = _cfg(kind)
    width = SpillCodec(TableSpec.from_config(cfg)).width
    srv = None
    if backend_kind == "disk":
        spill = make_backend("disk", width=width, path=str(tmp_path / "kv.log"))
    elif backend_kind == "redis":
        srv = FakeRespServer()
        spill = make_backend("redis", width=width, port=srv.port)
    else:
        spill = make_backend(backend_kind, width=width)
    try:
        t = DynamicEmbeddingTable(cfg, device="cpu", spill=spill)
        cold = np.arange(100, dtype=np.int64) * 7919 + 1
        hot = np.arange(50, dtype=np.int64) * 104729 + 10**12
        for _ in range(3):
            rows = t.lookup(cold, train=True)
            t.apply_grads(rows * 0.1 + 0.01)
        before = _state(t)
        for _ in range(8):
            rows = t.lookup(hot, train=True)
            t.apply_grads(rows * 0.1)
        assert t.evict() == 100 and len(spill) == 100
        assert not t.lookup(cold, train=False).any()
        _, found = spill.lookup_batch(cold)
        assert found.all()

        t.lookup(cold, train=True)  # misses: fresh rows, and the promoter is fed
        t._promoter.flush(timeout=60)
        t._apply_promotions()
        after = _state(t)
        for k in map(int, cold):
            assert sorted(after[k]) == sorted(before[k])
            for name in after[k]:
                if name != "last":
                    np.testing.assert_array_equal(after[k][name], before[k][name], err_msg=name)
        _, found = spill.lookup_batch(cold)
        assert not found.any()
        c = t.counters()
        assert c["promotes"] == 100 and c["spills"] == 100 and c["evictions"] == 100
        assert c["spilled_resident"] == 0
    finally:
        t._promoter.close()
        if hasattr(spill, "close"):
            spill.close()
        if srv is not None:
            srv.close()


def test_lfu_eviction_keeps_hot_rows():
    t = DynamicEmbeddingTable(_cfg(evict_policy="lfu", lfu_min_freq=3), device="cpu")
    hot = np.arange(20, dtype=np.int64) + 1
    cold = np.arange(20, dtype=np.int64) + 1000
    for _ in range(5):
        rows = t.lookup(hot, train=True)
        t.apply_grads(rows * 0.1)
    rows = t.lookup(cold, train=True)
    t.apply_grads(rows * 0.1)
    assert t.evict() == 20
    assert {int(k) for ids, *_ in t.export_items() for k in ids} == set(map(int, hot))


def test_windowed_evict_cursor_sweeps_whole_table():
    """Windows of 8 of 32 buckets: one lap evicts every expired row and no
    row touched since, and the cursor is back at 0."""
    t = DynamicEmbeddingTable(_cfg(evict_scan_buckets=8, capacity=1 << 12), device="cpu")
    rng = np.random.default_rng(0)
    old = rng.integers(1, 10**12, size=600).astype(np.int64)
    t.lookup(old, train=True)
    t.apply_grads(np.zeros((600, 16), np.float32))
    t.step = 50
    hot = rng.integers(10**12, 2 * 10**12, size=100).astype(np.int64)
    t.lookup(hot, train=True)
    t.apply_grads(np.zeros((100, 16), np.float32))
    total = sum(t.evict() for _ in range(4))
    assert total == len(set(old.tolist()))
    assert len(t) == len(set(hot.tolist()))
    assert t._evict_cursor == 0


def test_windowed_evict_wraps_at_non_divisor_K():
    """nb = 32, K = 7: the last window of a lap wraps, so nb passes (K laps)
    evict every expired row exactly once."""
    t = DynamicEmbeddingTable(_cfg(evict_scan_buckets=7, capacity=24 * 128), device="cpu")
    nb = t.spec.num_buckets
    assert nb % 7
    rng = np.random.default_rng(1)
    old = rng.integers(1, 10**12, size=900).astype(np.int64)
    t.lookup(old, train=True)
    t.apply_grads(np.zeros((900, 16), np.float32))
    t.step = 50
    total = sum(t.evict() for _ in range(nb))
    assert total == len(set(old.tolist()))
    assert int(t.shard.cnt.sum()) == 0


def test_promotion_slot_race_respills_no_row_lost():
    """Promotions into a full one-bucket table: every staged row goes back
    to the cold tier with its exact payload, staged == promoted + respilled."""
    cfg = _cfg(ttl=3, capacity=128)
    spill = make_backend("python", width=SpillCodec(TableSpec.from_config(cfg)).width)
    t = DynamicEmbeddingTable(cfg, device="cpu", spill=spill)
    a_ids = np.arange(120, dtype=np.int64) * 7919 + 1
    for _ in range(2):
        rows = t.lookup(a_ids, train=True)
        t.apply_grads(rows * 0.1 + 0.01)
    trained = {int(k): rows[i].numpy() for ids, rows, _, _ in t.export_items()
               for i, k in enumerate(ids)}
    t.step = 50
    assert t.evict() == 120
    b_ids = np.arange(400, dtype=np.int64) * 104729 + 10**12
    t.lookup(b_ids, train=True)
    assert int(t.shard.cnt.sum()) == 128
    t.lookup(a_ids, train=True)
    t._promoter.flush(timeout=60)
    t._apply_promotions()
    eng = t._promoter
    assert eng.staged == 120 and eng.promoted == 0 and eng.respilled == 120
    payload, found = spill.lookup_batch(a_ids)
    assert found.all()
    vals = SpillCodec(t.spec).unpack(payload)["values"]
    for i, k in enumerate(map(int, a_ids)):
        np.testing.assert_array_equal(vals[i], trained[k])
    assert t.counters()["promote_respills"] == 120
    eng.close()


def test_promotion_matches_jax_table():
    """The same evict -> spill -> promote sequence through both packages'
    tables (no training, so the rows are exact): the tables' planes and
    counters and the cold tiers equal after each step."""
    table = dict(dim=8, capacity=1 << 11, max_probe_rounds=2)
    policy = dict(evict_policy="ttl", ttl_steps=3, max_evict_per_pass=1 << 9)
    jcfg = JTableConfig(**table, policy=JPolicyConfig(**policy))
    tcfg = TableConfig(**table, policy=PolicyConfig(**policy))
    jspill = jmake_backend("python", width=JSpillCodec(JTableSpec.from_config(jcfg)).width)
    tspill = make_backend("python", width=SpillCodec(TableSpec.from_config(tcfg)).width)
    jt, tt = JTable(jcfg, spill=jspill), DynamicEmbeddingTable(tcfg, device="cpu", spill=tspill)
    rng = np.random.default_rng(7)
    ids = rng.integers(1, 2**62, size=700, dtype=np.int64)
    for t in (jt, tt):
        t.lookup(ids, train=True)
        # the promoter's worker reads this lookup's misses against the cold
        # tier on its own thread: let it finish before the eviction below
        # fills the tier, or a late read would stage the evicted rows
        t._promoter.flush(timeout=60)
        t.step = 10
    assert tt.evict() == jt.evict() > 0
    assert _store(tspill).keys() == _store(jspill).keys()
    for t in (jt, tt):
        t.lookup(ids[:300], train=True)
        t._promoter.flush(timeout=60)
        t.lookup(ids[:300], train=True)
    assert_planes_equal(jt.shard, tt.shard, "after promotion")
    assert tt.counters() == jt.counters()
    assert _store(tspill).keys() == _store(jspill).keys()
    for t in (jt, tt):
        t._promoter.close()
