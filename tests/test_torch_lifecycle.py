"""The port's table lifecycle against the JAX package's, on the CPU:
`evict_pass`, `next_evict_cursor`, `erase_keys` and `remove`,
`check_invariants`, `regrow_shard` and growth through `lookup(train=True)`.

Each case starts both packages from one state, built by the JAX package's
`insert_rows` (random freq, last and optimizer state) and carried into the
port plane for plane (`_torch_train_parity.to_torch_shard`). Exports,
masks, counts, invariant dicts and every plane after the call must be
equal bit for bit. The port clears freed slots by setting them where the
reference subtracts; for finite rows that gives the same bits, and these
states hold only finite rows."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_train_parity import (
    assert_planes_equal,
    assert_tables_match,
    numpy_planes,
    to_jax_shard,
    to_torch_shard,
)

from meepoembedding_tpu.config import OptimizerConfig as JOptimizerConfig
from meepoembedding_tpu.config import PolicyConfig as JPolicyConfig
from meepoembedding_tpu.config import TableConfig as JTableConfig
from meepoembedding_tpu.table import hashing as jh
from meepoembedding_tpu.table import layout as jl
from meepoembedding_tpu.table import runtime as jrt
from meepoembedding_tpu.table import xla_ops as jx
from meepoembedding_tpu_torch.config import OptimizerConfig, PolicyConfig, TableConfig
from meepoembedding_tpu_torch.table import layout as tl
from meepoembedding_tpu_torch.table import runtime as trt
from meepoembedding_tpu_torch.table import table_ops as tx

torch.set_num_threads(1)

DIM, CAP, STEP = 8, 4096, 40  # 32 buckets


def _configs(kind="rowwise_adagrad", value_dtype="float32", capacity=CAP, **policy):
    table = dict(dim=DIM, capacity=capacity, value_dtype=value_dtype)
    jcfg = JTableConfig(**table, optimizer=JOptimizerConfig(kind=kind),
                        policy=JPolicyConfig(**policy))
    tcfg = TableConfig(**table, optimizer=OptimizerConfig(kind=kind), policy=PolicyConfig(**policy))
    return jcfg, tcfg


def _specs(jcfg, tcfg):
    return jl.TableSpec.from_config(jcfg), tl.TableSpec.from_config(tcfg)


def _state(jspec, n=2600, seed=0):
    """Planes of a table holding n random rows (two insert batches), with
    freq in [1, 6), last in [0, 40) and random optimizer state; and the ids."""
    rng = np.random.default_rng(seed)
    shard = jl.alloc_shard(jspec)
    ids = rng.integers(-(2**63), 2**63 - 1, size=n, dtype=np.int64)
    for half in (ids[: n // 2], ids[n // 2:]):
        m = len(half)
        hi, lo = jh.split_ids(half)
        full = tuple(jnp.asarray(rng.normal(size=(m, jspec.dim)).astype(np.float32))
                     for _ in range(jspec.optimizer.num_fulldim_slots()))
        shard, _ = jrt._insert(
            jspec, shard, jnp.asarray(hi), jnp.asarray(lo),
            jnp.asarray(rng.normal(size=(m, jspec.dim)).astype(np.float32)),
            jnp.ones((m,), bool), jnp.int32(0),
            jnp.asarray(rng.integers(1, 6, size=m).astype(np.int32)),
            jnp.asarray(rng.random(m).astype(np.float32)), full,
            jnp.asarray(rng.integers(0, STEP, size=m).astype(np.int32)))
    return numpy_planes(shard), ids


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if str(a.dtype) == "bfloat16" else a


EVICT_CASES = [
    ("lfu", None, "rowwise_adagrad", "float32"),
    ("ttl", None, "rowwise_adagrad", "float32"),
    ("lfu_ttl", None, "rowwise_adagrad", "float32"),
    ("lfu", 7, "rowwise_adagrad", "float32"),
    ("ttl", 7, "rowwise_adagrad", "float32"),
    ("lfu_ttl", 7, "rowwise_adagrad", "float32"),
    ("lfu_ttl", 7, "adam", "bfloat16"),
    ("ttl", None, "sgd", "float32"),
]


@pytest.mark.parametrize("policy,window,kind,dtype", EVICT_CASES,
                         ids=[f"{p}-K{w}-{k}-{d}" for p, w, k, d in EVICT_CASES])
def test_evict_pass_matches_jax(policy, window, kind, dtype):
    """Full scans (where the 200-row cap binds) and windows of K = 7 of 32
    buckets from offset 28, which wrap to buckets 0-2."""
    jspec, tspec = _specs(*_configs(kind, dtype, evict_policy=policy, lfu_min_freq=3,
                                    ttl_steps=25, max_evict_per_pass=200,
                                    evict_scan_buckets=window))
    planes, _ = _state(jspec)
    jshard, tshard = to_jax_shard(planes, jspec), to_torch_shard(planes, tspec)
    off = None if window is None else 28
    jshard, jexp = jrt._evict(jspec, jshard, jnp.int32(STEP),
                              None if off is None else jnp.int32(off))
    texp = tx.evict_pass(tspec, tshard, STEP, off)
    assert texp.count == int(jexp.count) > 0
    if window is None:
        assert texp.count == 200
    for name in ("hi", "lo", "freq", "accum"):
        np.testing.assert_array_equal(getattr(texp, name).numpy(),
                                      np.asarray(getattr(jexp, name)), err_msg=name)
    for got, want in zip((texp.rows, *texp.fulldim), (jexp.rows, *jexp.fulldim)):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert len(texp.fulldim) == len(jexp.fulldim)
    assert_planes_equal(jshard, tshard, f"after evict {policy}")


def test_next_evict_cursor_matches_jax():
    for k in (None, 7, 8, 32, 40):
        jspec, tspec = _specs(*_configs(evict_policy="ttl", evict_scan_buckets=k))
        jc = tc = 0
        for _ in range(70):
            jc, tc = jx.next_evict_cursor(jspec, jc), tx.next_evict_cursor(tspec, tc)
            assert tc == jc


def test_erase_keys_matches_jax():
    """300 live ids, 100 absent ids and padding, deduplicated."""
    jspec, tspec = _specs(*_configs())
    planes, ids = _state(jspec)
    rng = np.random.default_rng(3)
    q = np.concatenate([rng.choice(ids, 300, replace=False),
                        rng.integers(1, 2**62, size=100, dtype=np.int64)])
    q = np.unique(q)
    hi, lo = jh.split_ids(np.concatenate([q, np.full(12, jh.EMPTY_ID, np.int64)]))
    valid = jh.is_valid(hi, lo)
    jshard, jfound = jrt._erase(jspec, to_jax_shard(planes, jspec), jnp.asarray(hi),
                                jnp.asarray(lo), jnp.asarray(valid))
    tshard = to_torch_shard(planes, tspec)
    tfound = tx.erase_keys(tspec, tshard, torch.from_numpy(hi), torch.from_numpy(lo),
                           torch.from_numpy(valid))
    np.testing.assert_array_equal(tfound.numpy(), np.asarray(jfound))
    assert int(tfound.sum()) == 300
    assert_planes_equal(jshard, tshard, "after erase")


def test_remove_matches_jax_table():
    cfg = dict(dim=DIM, capacity=2048)
    jt, tt = jrt.DynamicEmbeddingTable(JTableConfig(**cfg)), trt.DynamicEmbeddingTable(
        TableConfig(**cfg), device="cpu")
    rng = np.random.default_rng(5)
    ids = rng.integers(1, 2**62, size=1200, dtype=np.int64)
    rows = rng.normal(size=(1200, DIM)).astype(np.float32)
    np.testing.assert_array_equal(tt.assign(ids, rows), np.asarray(jt.assign(ids, rows)))
    q = np.concatenate([ids[:400], ids[:50], rng.integers(-(2**62), -1, size=30)])
    assert tt.remove(q) == jt.remove(q) == 400
    assert tt.remove(torch.from_numpy(ids[:10])) == 0  # already gone
    assert tt.counters()["erases"] == jt.counters()["erases"] == 400
    assert len(tt) == len(jt) == 800
    assert_planes_equal(jt.shard, tt.shard, "after remove")
    np.testing.assert_array_equal(tt.lookup(ids[:600], train=False).numpy(),
                                  np.asarray(jt.lookup(ids[:600], train=False)))


def _corrupt(planes, kind, ids, spec):
    """One violation of the named kind in a copy of `planes`."""
    p = {k: (v.copy() if isinstance(v, np.ndarray) else [x.copy() for x in v])
         for k, v in planes.items()}
    live = ~((p["key_hi"] == jh.EMPTY_HI) & (p["key_lo"] == jh.EMPTY_LO))
    nb = spec.num_buckets

    def free_lane(b):
        return int(np.nonzero(~live[b])[0][0])

    if kind == "cnt_mismatch":
        p["cnt"][3] += 2
    elif kind == "load_overflow":
        p["cnt"][5] = 130
    elif kind == "free_values_resid":
        b = 7
        p["values"].reshape(nb * 128, -1)[b * 128 + free_lane(b)] = 1.0
    elif kind in ("bad_placement", "dup_keys"):
        new = np.int64(123456789) if kind == "bad_placement" else ids[0]
        hi, lo = jh.split_ids(np.array([new]))
        home = int(np.asarray(jh.bucket_of(jnp.asarray(hi), jnp.asarray(lo), nb))[0])
        # bucket home ^ 8 lies beyond 4 probe rounds; a duplicate stays home
        b = home ^ 8 if kind == "bad_placement" else home
        lane = free_lane(b)
        p["key_hi"][b, lane], p["key_lo"][b, lane] = hi[0], lo[0]
        p["cnt"][b] += 1
    return p


@pytest.mark.parametrize("kind", ["healthy", "cnt_mismatch", "bad_placement", "dup_keys",
                                  "free_values_resid", "load_overflow"])
def test_check_invariants_matches_jax(kind):
    jspec, tspec = _specs(*_configs())
    planes, ids = _state(jspec)
    if kind != "healthy":
        planes = _corrupt(planes, kind, ids, jspec)
    want = {k: int(v) for k, v in jx.check_invariants(jspec, to_jax_shard(planes, jspec)).items()}
    # small chunks: the chunked scan must sum to the whole-shard answer
    got = tx.check_invariants(tspec, to_torch_shard(planes, tspec), chunk_buckets=5)
    assert got == want
    assert (kind == "healthy") == (not any(got.values()))
    if kind != "healthy":
        assert got[kind] > 0


@pytest.mark.parametrize("kind,dtype", [("rowwise_adagrad", "float32"), ("adam", "bfloat16")])
def test_regrow_shard_matches_jax(kind, dtype):
    """2,600 rows rehashed from 2^12 into 2^13 slots, in 2^14-row batches."""
    jcfg, tcfg = _configs(kind, dtype)
    jspec, tspec = _specs(jcfg, tcfg)
    planes, _ = _state(jspec)
    jnew, tnew = _specs(dataclasses.replace(jcfg, capacity=2 * CAP),
                        dataclasses.replace(tcfg, capacity=2 * CAP))
    jshard = jrt.regrow_shard(jspec, jnew, to_jax_shard(planes, jspec), STEP)
    tshard = trt.regrow_shard(tspec, tnew, to_torch_shard(planes, tspec), STEP)
    assert int(tshard.cnt.sum()) == 2600
    assert_planes_equal(jshard, tshard, "after regrow")


def test_growth_in_train_lookup_matches_jax():
    """A table of 2^11 slots growing at load 0.6: both double at the same
    batch, to the same geometry and planes."""
    cfg = dict(dim=DIM, capacity=2048, grow_at_load=0.6)
    jt, tt = jrt.DynamicEmbeddingTable(JTableConfig(**cfg)), trt.DynamicEmbeddingTable(
        TableConfig(**cfg), device="cpu")
    rng = np.random.default_rng(11)
    caps = []
    for _ in range(5):
        ids = rng.integers(1, 2**62, size=400, dtype=np.int64)
        np.testing.assert_array_equal(tt.lookup(ids, train=True).numpy(),
                                      np.asarray(jt.lookup(ids, train=True)))
        assert tt.spec.capacity == jt.spec.capacity
        caps.append(tt.spec.capacity)
    assert caps[0] == 2048 and caps[-1] == 4096
    assert len(tt) == len(jt) == 2000
    assert_tables_match(jt.spec, jt.shard, tt.shard)
    assert_planes_equal(jt.shard, tt.shard, "after growth")
