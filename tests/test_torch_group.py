"""The port's table groups against the JAX package's: `TableGroup`,
`GroupTrainer` (heads, steps, growth, eviction, spill, promotion, remove,
checkpoints) and the single-device `GroupScoringService`, each from one
state on the same numpy batches.

Exact: every member's key, freq, last, cnt and ovf planes and counters (so
slots, unique order, inserts, drops and evictions), the spilled and
promoted rows, rows restored from checkpoints, and group.json's bytes.
Within rtol 1e-5 / atol 1e-6: losses, logits, values, optimizer state and
dense params (f32 matmuls and segment sums in another order; the
reference's rowwise accumulator sums over 128 window lanes)."""

import json
import logging
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_train_parity import TOL, assert_tables_match

from meepoembedding_tpu import config as jc
from meepoembedding_tpu.backends import make_backend as jmake_backend
from meepoembedding_tpu.group_train import GroupTrainer as JGroupTrainer
from meepoembedding_tpu.serving_group import GroupScoringService as JGroupScoringService
from meepoembedding_tpu.table import hashing as jh
from meepoembedding_tpu.table.group import TableGroup as JTableGroup
from meepoembedding_tpu.table.layout import TableSpec as JTableSpec
from meepoembedding_tpu.tiering import SpillCodec as JSpillCodec
from meepoembedding_tpu_torch import config as tc
from meepoembedding_tpu_torch.backends import make_backend
from meepoembedding_tpu_torch.group_train import GroupDotHead, GroupTrainer, GroupWideHead
from meepoembedding_tpu_torch.serving import make_http_server
from meepoembedding_tpu_torch.serving_group import GroupScoringService
from meepoembedding_tpu_torch.table.group import TableGroup
from meepoembedding_tpu_torch.table.layout import TableSpec
from meepoembedding_tpu_torch.tiering import SpillCodec
from meepoembedding_tpu_torch.train import Trainer
from meepoembedding_tpu_torch.weights import from_jax_params, to_jax_adam_state, to_jax_params

torch.set_num_threads(1)

B, ND = 64, 3
FEATURES = ["user", "item", "item"]  # the candidate and the history item share a table


def tables(pkg, user=None, item=None):
    """A heterogeneous group in the package `pkg`'s config classes: user ids
    at dim 8 with rowwise AdaGrad, item ids at dim 16 with FTRL, unless
    overridden (dicts of TableConfig fields; "opt"/"policy" nest)."""
    def cfg(kw):
        kw = dict(kw)
        opt = pkg.OptimizerConfig(**kw.pop("opt"))
        policy = pkg.PolicyConfig(**kw.pop("policy", {}))
        return pkg.TableConfig(**kw, optimizer=opt, policy=policy)

    base = dict(capacity=1 << 11, initializer_scale=0.05, max_probe_rounds=2)
    return {
        "user": cfg({**base, "dim": 8, "opt": dict(kind="rowwise_adagrad", learning_rate=0.1),
                     **(user or {})}),
        "item": cfg({**base, "dim": 16, "opt": dict(kind="ftrl", learning_rate=0.05),
                     **(item or {})}),
    }


def model(pkg, **kw):
    return pkg.ModelConfig(**{**dict(kind="ctr_mlp", num_dense_features=ND,
                                     num_sparse_features=3, top_mlp=(16, 1)), **kw})


def run(pkg, **kw):
    return pkg.RunConfig(**{**dict(batch_size=B, steps=10, seed=0,
                                   dense_learning_rate=3e-3), **kw})


def batch(rng, bag=1, users=500, items=200, b=B):
    shape = (b,) if bag == 1 else (b, bag)
    ids = np.stack([rng.integers(0, users, shape), rng.integers(0, items, shape),
                    rng.integers(0, items, shape)], axis=1).astype(np.int64)
    if bag > 1:  # ragged bags, and one empty bag
        ids[rng.random(ids.shape) < 0.3] = jh.EMPTY_ID
        ids[0, 1] = jh.EMPTY_ID
    return {"ids": ids, "dense": rng.normal(size=(b, ND)).astype(np.float32),
            "label": rng.integers(0, 2, size=b).astype(np.float32)}


def pair(user=None, item=None, spill=(), **model_kw):
    """A JAX GroupTrainer and the port's from one state: the JAX head's
    params carried across, both tables empty. `spill`: member names given a
    host spill tier in each package."""
    jt_tables, t_tables = tables(jc, user, item), tables(tc, user, item)
    jspill = {n: jmake_backend("host", width=JSpillCodec(JTableSpec.from_config(
        jt_tables[n])).width) for n in spill}
    tspill = {n: make_backend("host", width=SpillCodec(TableSpec.from_config(
        t_tables[n])).width) for n in spill}
    jt = JGroupTrainer(run(jc), jt_tables, FEATURES, model(jc, **model_kw), spill=jspill)
    tt = GroupTrainer(run(tc), t_tables, FEATURES, model(tc, **model_kw), spill=tspill,
                      device="cpu")
    from_jax_params(tt.head, jax.tree_util.tree_map(np.asarray, jt.params))
    return jt, tt


def jax_step(jt, b):
    """`JGroupTrainer.train_step`, keeping its logits."""
    jt._maybe_grow(np.asarray(b["ids"]))
    hi, lo = jh.split_ids(b["ids"])
    jt.shards, jt.params, jt.opt_state, loss, logits, miss = jt._step_fn(
        jt.shards, jt.params, jt.opt_state, jnp.asarray(b["dense"]), jnp.asarray(hi),
        jnp.asarray(lo), jnp.asarray(b["label"]), jnp.int32(jt.step))
    jt.step += 1
    for n, prm in jt._promoters.items():
        prm.feed(*miss[n])
    return float(loss), np.asarray(logits)


def assert_groups_match(jt, tt):
    assert tt.names == jt.names and tt.step == jt.step
    for n in jt.names:
        assert tt.specs[n].capacity == jt.specs[n].capacity, n
        assert_tables_match(jt.specs[n], jt.shards[n], tt.shards[n])
    jcount, tcount = jt.counters(), tt.counters()
    for n in jt.names:
        assert {k: tcount[n][k] for k in jcount[n]} == jcount[n], n
    jleaves = jax.tree_util.tree_leaves(jt.params)
    tleaves = to_jax_params(tt.head)
    assert len(jleaves) == len(tleaves)
    for j, (a, b) in enumerate(zip(jleaves, tleaves)):
        np.testing.assert_allclose(b, np.asarray(a), **TOL, err_msg=f"param leaf {j}")


@pytest.mark.parametrize("bag", [1, 4])
def test_steps_match_jax(bag):
    """3 steps of a heterogeneous ctr_mlp group with shared columns (and
    multi-hot bags): loss, logits, every plane, counters and params; then a
    probe-only eval."""
    jt, tt = pair()
    rng = np.random.default_rng(bag)
    for step in range(3):
        b = batch(rng, bag)
        jloss, jlogits = jax_step(jt, b)
        tloss = tt.train_step(b)["loss"]
        np.testing.assert_allclose(tloss, jloss, **TOL, err_msg=f"loss, step {step}")
        np.testing.assert_allclose(tt.last_logits.numpy(), jlogits, **TOL,
                                   err_msg=f"logits, step {step}")
    assert_groups_match(jt, tt)
    assert tt.counters()["item"]["inserts"] > 0 and tt.counters()["item"]["hits"] > 0
    b = batch(rng, bag, users=800, items=300)  # known and unknown ids
    jev, tev = jt.eval_step(b), tt.eval_step(b)
    np.testing.assert_allclose(tev["loss"], jev["loss"], **TOL)
    np.testing.assert_allclose(tev["logits"].numpy(), np.asarray(jev["logits"]), **TOL)


def test_shared_columns_dedup_once():
    """An id in both item columns inserts once (the columns dedup together)."""
    tt = GroupTrainer(run(tc), tables(tc), FEATURES, model(tc), device="cpu")
    ids = np.zeros((B, 3), np.int64)
    ids[:, 0] = np.arange(B)
    ids[:, 1:] = 7
    tt.train_step({"ids": ids, "dense": np.zeros((B, ND), np.float32),
                   "label": np.ones(B, np.float32)})
    c = tt.counters()
    assert c["item"]["rows"] == c["item"]["inserts"] == 1 and c["user"]["rows"] == B


def test_dlrm_head_equals_single_table_trainer():
    """kind=dlrm on a dot-compatible group (one table serving every column)
    computes the single-table Trainer's DLRM: same losses, tables, logits."""
    table = tc.TableConfig(dim=16, capacity=1 << 12, initializer_scale=0.05,
                           optimizer=tc.OptimizerConfig(kind="rowwise_adagrad",
                                                        learning_rate=0.05))
    mc = model(tc, kind="dlrm", embedding_dim=16, bottom_mlp=(32, 16), top_mlp=(32, 1))
    single = Trainer(run(tc), table, mc, device="cpu")
    group = GroupTrainer(run(tc), {"t": table}, ["t", "t", "t"], mc, device="cpu")
    assert isinstance(group.head, GroupDotHead)
    from_jax_params(group.head, to_jax_params(single.model))
    rng = np.random.default_rng(7)
    for _ in range(4):
        b = batch(rng)
        np.testing.assert_allclose(group.train_step(b)["loss"], single.train_step(b)["loss"],
                                   **TOL)
    for name in ("key_hi", "key_lo", "freq", "last", "cnt", "ovf", "counters"):
        assert torch.equal(getattr(group.shards["t"], name), getattr(single.shard, name)), name
    for a, b in ((group.shards["t"].values, single.shard.values),
                 (group.shards["t"].opt_rowwise[0], single.shard.opt_rowwise[0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    b = batch(rng, users=900, items=400)
    np.testing.assert_allclose(group.eval_step(b)["logits"].numpy(),
                               single.eval_step(b)["logits"].numpy(), **TOL)


def test_fallback_and_refusals(caplog):
    with caplog.at_level(logging.WARNING):
        tt = GroupTrainer(run(tc), tables(tc), FEATURES, model(tc, kind="dlrm"), device="cpu")
    assert isinstance(tt.head, GroupWideHead) and "not dot-compatible" in caplog.text
    jt = JGroupTrainer(run(jc), tables(jc), FEATURES, model(jc, kind="dlrm"))
    assert "mlp" in jt.params and len(to_jax_params(tt.head)) == len(
        jax.tree_util.tree_leaves(jt.params))
    bad = [
        dict(model_cfg=model(tc, kind="din")),
        dict(feature_map=["user", "nope", "item"]),
        dict(feature_map=["user", "user", "user"]),
        dict(table_cfgs={**tables(tc), "wide": tc.TableConfig(dim=256, capacity=1 << 12)},
             feature_map=FEATURES + ["wide"]),
        dict(spill={"nope": make_backend("python", width=9)}),
    ]
    for kw in bad:
        args = dict(run_cfg=run(tc), table_cfgs=tables(tc), feature_map=FEATURES,
                    model_cfg=model(tc), device="cpu")
        with pytest.raises(ValueError):
            GroupTrainer(**{**args, **kw})
    with pytest.raises(AssertionError, match="single table"):
        JGroupTrainer(run(jc), tables(jc), FEATURES, model(jc, kind="din"))


def test_growth_eviction_spill_promotion_remove_match_jax():
    """A growable rowwise-AdaGrad user table beside an LFU/TTL item table
    with a host spill tier: steps, per-member maintenance (eviction into the
    tier, promotion back), remove and growth give the same planes, counters,
    spilled rows and maintenance reports in both packages."""
    jt, tt = pair(user=dict(capacity=1 << 10, grow_at_load=0.6),
                  item=dict(dim=8, opt=dict(kind="rowwise_adagrad", learning_rate=0.1),
                            policy=dict(evict_policy="lfu_ttl", ttl_steps=3,
                                        max_evict_per_pass=1 << 10)),
                  spill=("item",))
    rng = np.random.default_rng(0)
    cold = np.arange(1, B + 1, dtype=np.int64) * 7919

    def cold_batch(item_ids):
        b = batch(rng, users=5000)
        b["ids"][:, 1] = b["ids"][:, 2] = item_ids
        return b

    def both_step(b):
        jax_step(jt, b)
        tt.train_step(b)
        for pkg in (jt, tt):
            for prm in pkg._promoters.values():
                prm.flush()

    for k in range(11):
        both_step(cold_batch(cold) if k < 2 or k == 9 else batch(rng, users=5000, items=900))
        if k % 4 == 3 or k == 9:
            assert tt.maintenance() == jt.maintenance(), f"maintenance after step {k}"
            assert_groups_match(jt, tt)
    c = tt.counters()
    assert c["user"]["capacity"] > 1 << 10 and c["item"]["evictions"] > 0
    assert c["item"]["spills"] > 0 and c["item"]["promotes"] > 0
    assert len(tt.spill["item"]) == len(jt.spill["item"])
    tkeys, tpay = tt.spill["item"].lookup_batch(cold)
    jkeys, jpay = jt.spill["item"].lookup_batch(cold)
    np.testing.assert_array_equal(tkeys, jkeys)
    np.testing.assert_array_equal(tpay, jpay)
    gone = np.concatenate([cold[:20], [10**15]])
    assert tt.remove("item", gone) == jt.remove("item", gone)
    assert_groups_match(jt, tt)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A JAX group and the port's trained 3 steps from one state (growable
    user member, grown during the steps), and the JAX group's checkpoint."""
    jt, tt = pair(user=dict(capacity=1 << 8, grow_at_load=0.6))
    rng = np.random.default_rng(3)
    for _ in range(3):
        b = batch(rng, users=5000)
        jax_step(jt, b)
        tt.train_step(b)
    assert jt.specs["user"].capacity > 1 << 8
    root = tmp_path_factory.mktemp("grp")
    jt.save_checkpoint(str(root / "jax"))
    return jt, tt, root


def _arrays(path) -> dict:
    """The arrays of an .npz or .npy file, by name."""
    z = np.load(path)
    if isinstance(z, np.ndarray):
        return {"": z}
    with z:
        return {k: z[k] for k in z.files}


def test_checkpoints_cross_restore_both_ways(trained):
    """JAX save -> port load and port save -> JAX load, both into trainers
    built from the original (smaller) config, which pre-grow: rows and
    Adam state bit for bit; group.json and each member's arrays equal to
    the reference's save."""
    jt, tt, root = trained
    mine = GroupTrainer(run(tc), tables(tc, dict(capacity=1 << 8, grow_at_load=0.6)),
                        FEATURES, model(tc), device="cpu")
    m = mine.load_checkpoint(str(root / "jax"))
    assert m["step"] == 3 and m["feature_map"] == FEATURES
    assert mine._live_upper["user"] == mine.counters()["user"]["rows"]
    for n in jt.names:
        assert mine.specs[n].capacity == jt.specs[n].capacity
        assert_tables_match(jt.specs[n], jt.shards[n], mine.shards[n])
        np.testing.assert_array_equal(mine.shards[n].values.numpy(), np.asarray(
            jt.shards[n].values).reshape(mine.shards[n].values.shape), err_msg=n)
    for a, b in zip(jax.tree_util.tree_leaves(jt.params), to_jax_params(mine.head)):
        np.testing.assert_array_equal(b, np.asarray(a))
    for a, b in zip(jax.tree_util.tree_leaves(jt.opt_state),
                    to_jax_adam_state(mine.opt_state, mine.head)):
        np.testing.assert_array_equal(b, np.asarray(a))

    mine.save_checkpoint(str(root / "port"))
    jt.save_checkpoint(str(root / "jax2"))
    for d in ("port", "jax2"):
        with open(root / d / "group.json", "rb") as f:
            assert f.read() == (root / "jax" / "group.json").read_bytes()
    for n in jt.names:
        mj, mp = (json.loads((root / d / f"table-{n}" / "manifest.json").read_text())
                  for d in ("jax2", "port"))
        assert mj == mp, n
        for f in sorted(os.listdir(root / "jax2" / f"table-{n}" / mj["dir"])):
            a, b = (_arrays(root / d / f"table-{n}" / m["dir"] / f)
                    for d, m in (("jax2", mj), ("port", mp)))
            assert sorted(a) == sorted(b), f
            for k in a:
                np.testing.assert_array_equal(b[k], a[k], err_msg=f"{n} {f} {k}")

    back = JGroupTrainer(run(jc), tables(jc, dict(capacity=1 << 8, grow_at_load=0.6)),
                         FEATURES, model(jc))
    back.load_checkpoint(str(root / "port"))
    for n in jt.names:
        assert_tables_match(back.specs[n], back.shards[n], mine.shards[n])
    with pytest.raises(ValueError, match="group mismatch"):
        GroupTrainer(run(tc), {"user": tables(tc)["user"]}, ["user"], model(tc),
                     device="cpu").load_checkpoint(str(root / "jax"))


def test_table_group_matches_jax(tmp_path):
    def group(pkg):
        return {"user": pkg.TableConfig(dim=16, capacity=1 << 11,
                                        optimizer=pkg.OptimizerConfig(kind="rowwise_adagrad")),
                "item": pkg.TableConfig(dim=8, capacity=1 << 10,
                                        optimizer=pkg.OptimizerConfig(kind="ftrl", l1=0.01))}

    jg, tg = JTableGroup(group(jc)), TableGroup(group(tc), device="cpu")
    rng = np.random.default_rng(4)
    uid = rng.integers(1, 10**9, size=100, dtype=np.int64)
    iid = rng.integers(1, 10**9, size=80, dtype=np.int64)
    for name, ids, dim in (("user", uid, 16), ("item", iid, 8)):
        np.testing.assert_allclose(tg.lookup(name, ids).numpy(), np.asarray(jg.lookup(name, ids)),
                                   **TOL)
        g = rng.normal(size=(len(ids), dim)).astype(np.float32)
        jg.apply_grads(name, jnp.asarray(g))
        tg.apply_grads(name, torch.from_numpy(g))
    assert len(tg) == len(jg) == len(np.unique(uid)) + len(np.unique(iid))
    assert tg.remove("item", iid[:10]) == jg.remove("item", iid[:10])
    jcount, tcount = jg.counters(), tg.counters()
    for n in ("user", "item"):
        assert {k: tcount[n][k] for k in jcount[n]} == jcount[n]
        assert_tables_match(jg[n].spec, jg[n].shard, tg[n].shard)
    jg.save(str(tmp_path / "jax"))
    tg.save(str(tmp_path / "port"))
    assert json.loads((tmp_path / "port" / "group.json").read_text()) == json.loads(
        (tmp_path / "jax" / "group.json").read_text())
    tg2 = TableGroup(group(tc), device="cpu")
    tg2.load(str(tmp_path / "jax"))
    jg2 = JTableGroup(group(jc))
    jg2.load(str(tmp_path / "port"))
    for name, ids in (("user", uid), ("item", iid)):
        np.testing.assert_array_equal(tg2.lookup(name, ids, train=False).numpy(),
                                      np.asarray(jg.lookup(name, ids, train=False)))
        np.testing.assert_array_equal(np.asarray(jg2.lookup(name, ids, train=False)),
                                      tg.lookup(name, ids, train=False).numpy())
    with pytest.raises(ValueError, match="group mismatch"):
        TableGroup({"user": group(tc)["user"]}, device="cpu").load(str(tmp_path / "jax"))


def test_group_scoring_matches_jax_and_http(trained, monkeypatch):
    jt, _, root = trained
    args = (tables(tc, dict(capacity=1 << 8, grow_at_load=0.6)), FEATURES, model(tc))
    svc = GroupScoringService(str(root / "jax"), run(tc), *args, device="cpu")
    jsvc = JGroupScoringService(str(root / "jax"), run(jc),
                                tables(jc, dict(capacity=1 << 8, grow_at_load=0.6)), FEATURES,
                                model(jc))
    assert svc.stats() == jsvc.stats() and svc.stats()["rows"] > 0
    rng = np.random.default_rng(9)
    for b, bag in ((64, 1), (13, 1), (8, 4)):
        bt = batch(rng, bag, users=6000, items=400, b=b)
        got = svc.score(bt["dense"], bt["ids"])
        assert got.shape == (b,)
        np.testing.assert_allclose(got, jsvc.score(bt["dense"], bt["ids"]), **TOL)
    # distributed=True on a world of one: the members behind the forced
    # exchange score what the single-device service scores
    from meepoembedding_tpu_torch.parallel import mesh as pmesh
    from meepoembedding_tpu_torch.parallel import sharded_table as st

    joined = not torch.distributed.is_initialized()
    monkeypatch.setattr(st, "FORCE_EXCHANGE", True)
    try:
        dsvc = GroupScoringService(str(root / "jax"), run(tc), *args, distributed=True,
                                   device="cpu")
        assert dsvc.S == 1 and dsvc.stats() == svc.stats()
        for b, bag in ((64, 1), (13, 1), (8, 4)):
            bt = batch(rng, bag, users=6000, items=400, b=b)
            np.testing.assert_allclose(dsvc.score(bt["dense"], bt["ids"]),
                                       svc.score(bt["dense"], bt["ids"]), **TOL)
        assert dsvc.route_drops == 0
    finally:
        if joined:
            pmesh.destroy()

    srv = make_http_server(svc, 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        h = json.loads(urllib.request.urlopen(base + "/healthz", timeout=30).read())
        assert h == svc.stats() and set(h["tables"]) == {"user", "item"}
        bt = batch(rng, b=3)
        req = json.dumps({"dense": bt["dense"].tolist(), "ids": bt["ids"].tolist()}).encode()
        r = json.loads(urllib.request.urlopen(urllib.request.Request(
            base + "/score", data=req), timeout=60).read())
        np.testing.assert_allclose(r["scores"], svc.score(bt["dense"], bt["ids"]), atol=1e-6)
        m = urllib.request.urlopen(base + "/metrics", timeout=30).read().decode()
        assert 'meepo_table_rows_total{table="user"}' in m
        r = json.loads(urllib.request.urlopen(urllib.request.Request(
            base + "/reload", data=b"{}"), timeout=60).read())
        assert r == jsvc.stats()
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)
    assert not th.is_alive()
