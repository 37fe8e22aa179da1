"""The port's `LockstepFront` (one HTTP front over S ranks) against the JAX
package's one-process services on meshes of S virtual CPU devices, on
checkpoints the JAX package wrote.

The port's side runs as worlds of S = 2 and 4 gloo processes
(`tests/_torch_dist_worker.py`, case "front"): rank 0 serves HTTP while a
client thread of its own posts global batches; the other ranks follow.
Exact: the rows of a lookup, /healthz rows, route drops and the /retrieve
keys. Within rtol 1e-5 / atol 1e-6 (`TOL`): scores. Also: /metrics names
the mesh size, a malformed body gets a 400 and the next request still
answers, a good /reload keeps the rows and a bad one (on every rank)
changes neither rows nor scores, the no-ops rank 0 sends while idle keep
the ranks in step, and the stop op makes every rank return 0."""

import json

import numpy as np
import pytest
import torch
from _torch_dist_parity import (
    MODEL,
    NSPARSE,
    TOL,
    jax_model,
    jax_table,
    run_ranks,
    trainer_case,
)

from meepoembedding_tpu.config import ModelConfig as JModelConfig
from meepoembedding_tpu.config import OptimizerConfig as JOptimizerConfig
from meepoembedding_tpu.config import RunConfig as JRunConfig
from meepoembedding_tpu.config import TableConfig as JTableConfig
from meepoembedding_tpu.group_train import GroupTrainer as JGroupTrainer
from meepoembedding_tpu.parallel.mesh import make_mesh
from meepoembedding_tpu.retrieval import RetrievalService as JRetrievalService
from meepoembedding_tpu.serving_group import GroupScoringService as JGroupScoringService
from meepoembedding_tpu.serving_sharded import ShardedScoringService as JShardedScoringService
from meepoembedding_tpu.train import Trainer as JTrainer

torch.set_num_threads(1)

# global batches: 37 pads to S * next_pow2(ceil(37 / S)); at S = 4 the
# exchange is tight, so that the batch of 1,000 drops ids
SIZES = (37, 64, 1000)
FACTOR = {2: 1.25, 4: 0.5}
BIG_ROWS = 4096  # more rows than the table case's bound on a rank's ids allows

# a two-tower (after tests/test_torch_retrieval.py): query id q pairs with item id q
ITEM_NS = np.int64(1) << 20
TT_MODEL = dict(kind="two_tower", num_dense_features=2, num_sparse_features=2,
                num_query_features=1, embedding_dim=16, bottom_mlp=[32, 16], top_mlp=[8, 1])
TT_TABLE = dict(dim=16, capacity=1 << 12,
                optimizer={"kind": "rowwise_adagrad", "learning_rate": 0.1})
K = 5

# a group (after tests/test_torch_group_sharded.py)
TABLES = {"user": {"dim": 16, "capacity": 1 << 13,
                   "optimizer": {"kind": "rowwise_adagrad", "learning_rate": 0.05}},
          "item": {"dim": 8, "capacity": 1 << 12,
                   "optimizer": {"kind": "ftrl", "learning_rate": 0.05}}}
FMAP = ["user", "item", "item"]
WIDE = {"kind": "ctr_mlp", "num_dense_features": 4, "num_sparse_features": 3,
        "embedding_dim": 16, "top_mlp": [32, 1]}
GROUP_RUN = dict(batch_size=64, steps=3, seed=5, pipeline_depth=0, dense_learning_rate=3e-3)


def _pair_batch(rng, batch=64):
    q = rng.integers(0, 32, size=batch)
    return {"ids": np.stack([q, ITEM_NS | q], axis=1).astype(np.int64),
            "dense": rng.normal(size=(batch, 2)).astype(np.float32) * 0.1,
            "label": np.ones(batch, np.float32)}


def _group_batch(rng, b):
    ids = np.stack([rng.integers(0, 4000, size=b), rng.integers(0, 900, size=b),
                    rng.integers(0, 900, size=b)], axis=1).astype(np.int64)
    ids[:, 0] += 1 << 40
    return {"dense": rng.standard_normal((b, 4)).astype(np.float32), "ids": ids,
            "label": (rng.random(b) < 0.3).astype(np.float32)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The JAX-written checkpoints, the requests, and the ranks' outputs of
    a world of 2 (one table, retrieval, a group) and one of 4 (one table)."""
    tmp = tmp_path_factory.mktemp("front")
    case, ref = trainer_case(2, seed=80, evaluate=False, remove=False)
    ckpt = str(tmp / "ckpt")
    ref["trainer"].save_checkpoint(ckpt)
    rng = np.random.default_rng(82)
    trained = case["inputs"]["ids"][:3].reshape(-1)
    inputs = {"lookup_ids": np.concatenate([trained[:60], [-12345, 7]])}
    for i, b in enumerate(SIZES):
        ids = trained[rng.integers(0, len(trained), b * NSPARSE)]
        unknown = rng.random(ids.size) < (0.1 if b < 1000 else 0.6)
        ids[unknown] = -rng.integers(1, 2**62, size=int(unknown.sum()))
        inputs[f"ids{i}"] = ids.reshape(b, NSPARSE)
        inputs[f"dense{i}"] = rng.standard_normal((b, 4)).astype(np.float32)
    out = {"ckpt": ckpt, "table": case["args"]["table"], "inputs": inputs}

    # a two-tower the JAX package trained, and its corpus and queries
    jt = JTrainer(JRunConfig(batch_size=64, steps=20, dense_learning_rate=3e-3),
                  jax_table(TT_TABLE), JModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                                                       for k, v in TT_MODEL.items()}))
    for _ in range(20):
        jt.train_step(_pair_batch(rng))
    tt_ckpt = str(tmp / "two_tower")
    jt.save_checkpoint(tt_ckpt)
    items = (ITEM_NS | np.arange(40, dtype=np.int64))[:, None]  # 8 of them never trained
    tt_inputs = {"items": items, "query_dense": rng.normal(size=(6, 2)).astype(np.float32),
                 "query_ids": rng.integers(0, 32, size=(6, 1)).astype(np.int64)}
    out["two_tower"] = {"ckpt": tt_ckpt, "inputs": tt_inputs}

    # a group the JAX package trained (its checkpoint restores on any S)
    gt = JGroupTrainer(JRunConfig(**GROUP_RUN), {n: jax_table(t) for n, t in TABLES.items()},
                       FMAP, jax_model(WIDE))
    for _ in range(2):
        gt.train_step(_group_batch(rng, 64))
    g_ckpt = str(tmp / "group")
    gt.save_checkpoint(g_ckpt)
    g_inputs = {}
    for i, b in enumerate(SIZES):
        gb = _group_batch(rng, b)
        g_inputs[f"dense{i}"], g_inputs[f"ids{i}"] = gb["dense"], gb["ids"]
    out["group"] = {"ckpt": g_ckpt, "inputs": g_inputs}


    def table_case(S):
        # the bound admits the batch of 1,000 (512 or 256 rows a rank, 4 ids
        # a row) and refuses BIG_ROWS
        args = {"path": ckpt, "table": out["table"], "model": MODEL, "factor": FACTOR[S],
                "max_rank_ids": 2048, "big_rows": BIG_ROWS}
        if S == 2:  # idle spells between the batches, filled with no-ops
            args["heartbeat"] = 0.2
        return {"fn": "front", "inputs": inputs, "args": args}

    out[2] = run_ranks(tmp, 2, [
        table_case(2),
        {"fn": "front", "inputs": tt_inputs,
         "args": {"path": tt_ckpt, "table": TT_TABLE, "model": TT_MODEL, "k": K}},
        {"fn": "front", "inputs": g_inputs,
         "args": {"path": g_ckpt, "tables": TABLES, "fmap": FMAP, "model": WIDE,
                  "run": GROUP_RUN}},
    ], timeout=120)
    (out[4],) = run_ranks(tmp, 4, [table_case(4)], timeout=120)
    return out


def _jax_service(worlds, S):
    return JShardedScoringService(worlds["ckpt"], jax_table(worlds["table"]), jax_model(MODEL),
                                  mesh=make_mesh(S), a2a_factor=FACTOR[S])


def _table_ranks(worlds, S):
    return worlds[S][0] if S == 2 else worlds[S]


@pytest.mark.parametrize("S", [2, 4])
def test_front_scores_and_rows_match_jax(worlds, S):
    """/score of global batches of 37, 64 and 1,000 rows, the rows of
    `front.table.lookup`, /healthz rows and the route drops, against the
    JAX service on a mesh of S."""
    js = _jax_service(worlds, S)
    inp, r0 = worlds["inputs"], _table_ranks(worlds, S)[0]
    for i in range(len(SIZES)):
        want = js.score(inp[f"dense{i}"], inp[f"ids{i}"])
        assert r0[f"scores{i}"].shape == want.shape == (SIZES[i],)
        np.testing.assert_allclose(r0[f"scores{i}"], want, **TOL)
    health = json.loads(str(r0["health"]))
    assert health["rows"] == len(js) and health["devices"] == S
    assert health["route_drops"] == js.route_drops
    assert (js.route_drops > 0) == (S == 4)
    np.testing.assert_array_equal(r0["rows"], js.lookup(inp["lookup_ids"]))
    assert (r0["rows"][-2] == 0).all()
    assert json.loads(str(r0["counters"]))["route_drops"] >= js.route_drops


@pytest.mark.parametrize("S", [2, 4])
def test_front_survives_bad_requests_and_stops(worlds, S):
    """A malformed body, a batch past the front's bound on a rank's ids and
    a bad reload answer 400 and change nothing; a good reload keeps the
    rows; the stop op ends every rank with 0."""
    ranks = _table_ranks(worlds, S)
    r0 = ranks[0]
    assert f"meepo_mesh_devices {S}" in str(r0["metrics"])
    assert int(r0["bad_body"]) == 400 and int(r0["bad_shape"]) == 400
    np.testing.assert_array_equal(r0["after_bad"], r0["scores0"])
    assert int(r0["too_big"]) == 400 and "2048" in str(r0["too_big_error"])
    np.testing.assert_array_equal(r0["after_too_big"], r0["scores0"])
    rows = json.loads(str(r0["health"]))["rows"]
    assert json.loads(str(r0["reload"]))[1]["rows"] == rows
    assert int(r0["bad_reload"]) == 400 and "-missing" in str(r0["bad_reload_error"])
    np.testing.assert_array_equal(r0["after_reload"], r0["scores0"])
    assert json.loads(str(r0["health_after"]))["rows"] == rows
    assert [int(r["rc"]) for r in ranks] == [0] * S


def test_front_retrieve_matches_jax(worlds):
    """/retrieve over the front at S = 2: the keys of the JAX
    RetrievalService over the JAX sharded service, scores within TOL."""
    tt = worlds["two_tower"]
    js = JShardedScoringService(tt["ckpt"], jax_table(TT_TABLE),
                                JModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                                                for k, v in TT_MODEL.items()}),
                                mesh=make_mesh(2))
    jr = JRetrievalService(js)
    jr.build_index(tt["inputs"]["items"])
    keys, scores = jr.retrieve(tt["inputs"]["query_dense"], tt["inputs"]["query_ids"], k=K)
    r0 = worlds[2][1][0]
    np.testing.assert_array_equal(r0["keys"], keys)
    np.testing.assert_allclose(r0["retrieve_scores"], scores, **TOL)
    assert [int(r["rc"]) for r in worlds[2][1]] == [0, 0]


def test_group_front_matches_jax(worlds):
    """/score through a group front at S = 2 against the JAX
    GroupScoringService(distributed=True) on a mesh of 2. The reference
    sizes a member's dedup by run.batch_size / S, whatever the request, so
    its service is made with run.batch_size 1,024, which holds the batch
    of 1,000; the port's sizes it by the request."""
    g = worlds["group"]
    ranks = worlds[2][2]
    js = JGroupScoringService(g["ckpt"], JRunConfig(**{**GROUP_RUN, "batch_size": 1024}),
                              {n: jax_table(t) for n, t in TABLES.items()}, FMAP,
                              jax_model(WIDE), distributed=True, mesh=make_mesh(2))
    for i in range(len(SIZES)):
        want = js.score(g["inputs"][f"dense{i}"], g["inputs"][f"ids{i}"])
        np.testing.assert_allclose(ranks[0][f"scores{i}"], want, **TOL)
    health = json.loads(str(ranks[0]["health"]))
    assert health["rows"] == js.stats()["rows"] and health["route_drops"] == 0
    assert "meepo_mesh_devices 2" in str(ranks[0]["metrics"])
    assert [int(r["rc"]) for r in ranks] == [0, 0]
