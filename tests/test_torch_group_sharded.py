"""The port's ShardedGroupTrainer and GroupScoringService(distributed=True)
over S = 2 gloo processes against the JAX package's on a mesh of 2
virtual CPU devices (after `tests/test_group_sharded.py`), from the same
numpy inputs: steps with the dense and the ragged exchange (with a member
growing), the pipelined trainer, the DLRM head, maintenance with spill and promotion, `remove`,
checkpoints across the sharded and single-device group trainers, and the
distributed group service.

Exact: integer planes, counters, removed and promoted counts, cold-tier
keys, every restore. Within rtol 1e-5 / atol 1e-6
(`tests/_torch_dist_parity.py`): values, optimizer state, losses, logits,
scores and cold-tier payloads; head params within atol 1e-4."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_dist_parity import (
    TOL,
    assert_params_match,
    assert_stacked_match,
    cat,
    jax_model,
    jax_table,
    params_inputs,
    run_ranks,
)

from meepoembedding_tpu.backends.host_kv import PyKVStore as JPyKVStore
from meepoembedding_tpu.config import RunConfig as JRunConfig
from meepoembedding_tpu.group_train import GroupTrainer as JGroupTrainer
from meepoembedding_tpu.group_train import ShardedGroupTrainer as JShardedGroupTrainer
from meepoembedding_tpu.parallel.mesh import make_mesh
from meepoembedding_tpu.serving_group import GroupScoringService as JGroupScoringService
from meepoembedding_tpu.table import hashing as jh
from meepoembedding_tpu.table import xla_ops as jx
from meepoembedding_tpu.table.layout import TableSpec as JTableSpec
from meepoembedding_tpu.tiering import SpillCodec as JSpillCodec
from meepoembedding_tpu_torch import config as tc
from meepoembedding_tpu_torch.group_train import GroupTrainer
from meepoembedding_tpu_torch.table import hashing
from meepoembedding_tpu_torch.weights import to_jax_params

torch.set_num_threads(1)

S = 2
TABLES = {"user": {"dim": 16, "capacity": 1 << 13, "initializer_scale": 0.02,
                   "optimizer": {"kind": "rowwise_adagrad", "learning_rate": 0.05}},
          "item": {"dim": 8, "capacity": 1 << 12, "initializer_scale": 0.02,
                   "optimizer": {"kind": "ftrl", "learning_rate": 0.05}}}
FMAP = ["user", "item", "item"]  # columns 1 and 2 share the item table
WIDE = {"kind": "ctr_mlp", "num_dense_features": 4, "num_sparse_features": 3,
        "embedding_dim": 16, "top_mlp": [32, 1]}
DOT = {"kind": "dlrm", "num_dense_features": 4, "num_sparse_features": 3,
       "embedding_dim": 16, "bottom_mlp": [16, 16], "top_mlp": [16, 1]}
POLICY = {"evict_policy": "lfu_ttl", "ttl_steps": 1, "lfu_min_freq": 2,
          "max_evict_per_pass": 256, "evict_scan_buckets": 8}


def group_batches(seed: int, steps: int, b: int = 64) -> dict:
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.integers(0, 4000, size=(steps, b)), rng.integers(0, 900, size=(steps, b)),
                    rng.integers(0, 900, size=(steps, b))], axis=2).astype(np.int64)
    ids[..., 0] += 1 << 40  # the user and item id spaces apart
    return {"dense": rng.standard_normal((steps, b, 4)).astype(np.float32), "ids": ids,
            "label": (rng.random((steps, b)) < 0.3).astype(np.float32)}


def jax_tables(tables: dict) -> dict:
    return {n: jax_table(t) for n, t in tables.items()}


def group_case(seed, steps=4, run_extra=None, tables=None, model=WIDE, evaluate=True,
               remove=None, maintenance_every=0, save=None, restore=None):
    """Both packages' sharded group trainers on the same global batches."""
    tables = tables or TABLES
    run = {**dict(batch_size=64, steps=max(steps, 1), seed=seed, pipeline_depth=0,
                  dense_learning_rate=3e-3), **(run_extra or {})}
    data = group_batches(seed, steps + 1)
    spill = {}
    if maintenance_every:
        spill = {n: JPyKVStore(JSpillCodec(JTableSpec.from_config(jax_table(t), S)).width)
                 for n, t in tables.items()}
    jt = JShardedGroupTrainer(JRunConfig(**run), jax_tables(tables), FMAP, jax_model(model),
                              mesh=make_mesh(S), spill=spill or None)
    inputs = {**data, **params_inputs(jt)}
    if restore:
        jt.load_checkpoint(restore)
    ref = {"trainer": jt, "losses": [], "evicted": []}
    for s in range(steps):
        ref["losses"].append(jt.train_step({k: v[s] for k, v in data.items()})["loss"])
        if maintenance_every and (s + 1) % maintenance_every == 0:
            for prm in jt._promoters.values():
                prm.flush()
            m = jt.maintenance()
            ref["evicted"].append([m[n]["evicted"] for n in jt.names])
    ref["losses"] += [loss for _, loss in jt.flush()]
    ref["losses"] = [x for x in ref["losses"] if x is not None]
    if spill:
        promote = {k: v[steps].copy() for k, v in data.items()}
        keys = np.array(sorted(spill["user"]._d), np.int64)[:64]
        promote["ids"][:len(keys), 0] = keys
        inputs.update({f"promote_{k}": v for k, v in promote.items()})
        jt.train_step(promote)
        jt.flush()
        for prm in jt._promoters.values():
            prm.flush()
        m = jt.maintenance()
        ref.update(promoted=[m[n]["promoted"] for n in jt.names], spill=spill)
    if evaluate:
        ref["eval"] = jt.eval_step({k: v[steps] for k, v in data.items()})
    args = {"run": run, "tables": tables, "fmap": FMAP, "model": model,
            "nparams": len(params_inputs(jt)), "steps": steps, "eval": evaluate,
            "maintenance_every": maintenance_every, "spill": sorted(spill)}
    if remove:
        col = FMAP.index(remove)
        inputs["remove_ids"] = np.concatenate([data["ids"][0, :30, col], [-7, 12345]])
        ref["removed"] = jt.remove(remove, inputs["remove_ids"])
        args["remove"] = remove
    for k, v in (("save", save), ("restore", restore)):
        if v:
            args[k] = v
    return {"fn": "group", "inputs": inputs, "args": args}, ref


def member_stacked(ranks: list, n: str) -> dict:
    p = f"{n}."
    return {k[len(p):]: np.concatenate([r[k] for r in ranks]) for k in ranks[0]
            if k.startswith(p) and not k.startswith(p + "spill")}


def member_counters(rank: dict, i: int) -> dict:
    return dict(zip((str(x) for x in rank["ctr_names"]), (int(v) for v in rank["ctr_values"][i])))


def check_group(ref, ranks, what, exact=False):
    jt = ref["trainer"]
    if ref["losses"]:
        np.testing.assert_allclose(ranks[0]["losses"], ref["losses"], **TOL, err_msg=what)
        np.testing.assert_array_equal(ranks[1]["losses"], ranks[0]["losses"])
    jc = jt.counters()
    for i, n in enumerate(jt.names):
        got = member_counters(ranks[0], i)
        assert {k: got[k] for k in jc[n]} == jc[n], (what, n, got, jc[n])
        assert_stacked_match(jt.stacked[n], member_stacked(ranks, n), exact=exact,
                             what=f"{what} {n}")
    for r in ranks:
        assert_params_match(jt, r)
        assert int(r["step"]) == jt.step
    if "eval" in ref:
        np.testing.assert_allclose(ranks[0]["eval_loss"], ref["eval"]["loss"], **TOL)
        np.testing.assert_allclose(cat(ranks, "eval_logits"), np.asarray(ref["eval"]["logits"]),
                                   **TOL)
        assert int(ranks[0]["eval_drops"]) == ref["eval"]["route_drops"] == 0
    if "removed" in ref:
        assert [int(r["removed"]) for r in ranks] == [ref["removed"]] * S and ref["removed"] > 0
    if "spill" in ref:
        np.testing.assert_array_equal(ranks[0]["evicted"], ref["evicted"])
        np.testing.assert_array_equal(ranks[0]["promoted"], ref["promoted"])
        assert ref["promoted"][jt.names.index("user")] > 0
        for n, be in ref["spill"].items():
            keys = np.concatenate([r[f"{n}.spill_keys"] for r in ranks])
            rows = np.concatenate([r[f"{n}.spill_rows"] for r in ranks])
            want = sorted(be._d)
            o = np.argsort(keys)
            np.testing.assert_array_equal(keys[o], want)
            if want:
                np.testing.assert_allclose(rows[o], np.stack([be._d[k] for k in want]), **TOL)


def single_rows(shard, spec=None) -> dict:
    """id -> (values row, freq) of a port or JAX single-device member."""
    if spec is None:  # the port's
        hi, lo = shard.key_hi.numpy().reshape(-1), shard.key_lo.numpy().reshape(-1)
        vals, freq = shard.values.float().numpy(), shard.freq.numpy().reshape(-1)
    else:
        hi, lo = np.asarray(shard.key_hi).reshape(-1), np.asarray(shard.key_lo).reshape(-1)
        slots = jnp.arange(spec.capacity, dtype=jnp.int32)
        vals = np.asarray(jx.gather_values(spec, shard.values, slots))
        freq = np.asarray(shard.freq).reshape(-1)
    live = ~((hi == jh.EMPTY_HI) & (lo == jh.EMPTY_LO))
    ids = hashing.join_ids(hi[live], lo[live]).tolist()
    return dict(zip(ids, zip(vals[live], freq[live])))


def ranks_rows(ranks: list, n: str, dim: int) -> dict:
    out = {}
    for r in ranks:
        hi, lo = r[f"{n}.key_hi"].reshape(-1), r[f"{n}.key_lo"].reshape(-1)
        live = ~((hi == jh.EMPTY_HI) & (lo == jh.EMPTY_LO))
        vals = r[f"{n}.values"].reshape(hi.shape[0], dim)
        ids = hashing.join_ids(hi[live], lo[live]).tolist()
        out.update(zip(ids, zip(vals[live], r[f"{n}.freq"].reshape(-1)[live])))
    return out


def assert_rows_equal(a: dict, b: dict, what: str):
    assert set(a) == set(b) and a, what
    for k in a:
        np.testing.assert_array_equal(a[k][0], b[k][0], err_msg=f"{what} {k}")
        assert a[k][1] == b[k][1], (what, k)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX references (and a single-device and a sharded JAX group
    checkpoint), then one gloo world of 2 running the port's side."""
    tmp = tmp_path_factory.mktemp("group_sharded")
    ck_single, ck_sharded, ck_port = (str(tmp / n) for n in ("single", "sharded", "port"))
    run = JRunConfig(batch_size=64, steps=3, seed=41, pipeline_depth=0, dense_learning_rate=3e-3)
    j1 = JGroupTrainer(run, jax_tables(TABLES), FMAP, jax_model(WIDE))
    data = group_batches(41, 3)
    for s in range(3):
        j1.train_step({k: v[s] for k, v in data.items()})
    j1.save_checkpoint(ck_single)
    dense = group_case(42, remove="user", save=ck_port)
    dense[1]["trainer"].save_checkpoint(ck_sharded)
    cases = {
        "dense": dense,
        # the ragged exchange, with the item member growing from 512 slots
        "ragged": group_case(42, run_extra={"a2a_ragged": True}, remove="item",
                             tables={**TABLES, "item": dict(TABLES["item"], capacity=512,
                                                            grow_at_load=0.5)}),
        "dlrm": group_case(43, tables={n: dict(t, dim=16) for n, t in TABLES.items()},
                           model=DOT),
        "maintenance": group_case(44, steps=6, maintenance_every=2, evaluate=False,
                                  tables={n: dict(t, policy=POLICY) for n, t in TABLES.items()}),
        "restore_single": group_case(45, steps=0, restore=ck_single),
    }
    # the pipelined trainer on the dense case's inputs (no save, no remove)
    pipe = dict(dense[0], args={k: v for k, v in dense[0]["args"].items()
                                if k not in ("save", "remove")})
    pipe["args"]["run"] = dict(pipe["args"]["run"], pipeline_depth=2)
    pipe["inputs"] = {k: v for k, v in pipe["inputs"].items() if k != "remove_ids"}
    cases["pipelined"] = (pipe, None)
    # the distributed service on the JAX sharded checkpoint
    rng = np.random.default_rng(46)
    score = {"score_dense": rng.standard_normal((24, 4)).astype(np.float32),
             "score_ids": group_batches(46, 1, 24)["ids"][0]}
    jsvc = JGroupScoringService(ck_sharded, JRunConfig(batch_size=64), jax_tables(TABLES), FMAP,
                                jax_model(WIDE), distributed=True, mesh=make_mesh(S))
    score_case, score_ref = group_case(47, steps=0, evaluate=False)
    score_case["inputs"].update(score)
    score_case["args"]["score"] = ck_sharded
    score_ref["scores"] = jsvc.score(score["score_dense"], score["score_ids"])
    cases["score"] = (score_case, score_ref)
    ranks = run_ranks(tmp, S, [c for c, _ in cases.values()], timeout=180.0)
    out = {name: (ref, r) for (name, (_, ref)), r in zip(cases.items(), ranks)}
    out.update(ck_single=ck_single, ck_sharded=ck_sharded, ck_port=ck_port)
    return out


@pytest.mark.parametrize("name", ["dense", "ragged", "dlrm"])
def test_sharded_group_steps_match_jax(world, name):
    ref, ranks = world[name]
    check_group(ref, ranks, name)
    if name == "ragged":  # both grew the item member alike (counters' capacity)
        assert ref["trainer"].specs["item"].capacity * S > 512


def test_pipelined_equals_synchronous(world):
    """pipeline_depth 2 retires the same losses, two steps later, as the
    synchronous trainer (held against the JAX one above), and reaches the
    same planes, params and eval."""
    _, ranks = world["pipelined"]
    _, sync = world["dense"]
    np.testing.assert_array_equal(ranks[0]["losses"], sync[0]["losses"])
    # (the dense case then removed user ids; the item member is untouched)
    for k in ("item.values", "item.opt_fulldim0", "item.key_hi", "param0", "eval_logits"):
        np.testing.assert_array_equal(ranks[0][k], sync[0][k], err_msg=k)
    assert np.isnan(ranks[0]["returned"][:2]).all()
    np.testing.assert_array_equal(ranks[0]["returned"][2:], sync[0]["losses"][:2])


def test_maintenance_spill_and_promotion_match_jax(world):
    ref, ranks = world["maintenance"]
    assert np.asarray(ref["evicted"]).sum() > 0
    check_group(ref, ranks, "maintenance")


def test_single_device_checkpoint_restores_sharded(world):
    """A JAX GroupTrainer's checkpoint restored on S = 2 ranks: every plane
    and the head as the JAX sharded group trainer's restore, and its eval."""
    ref, ranks = world["restore_single"]
    check_group(ref, ranks, "restore_single", exact=True)


def test_sharded_checkpoint_restores_on_one_device(world):
    """The port's S = 2 save: the reference's group layout (group.json with
    num_shards), read back bit for bit by both packages' GroupTrainer."""
    _, ranks = world["dense"]
    ck = world["ck_port"]
    with open(os.path.join(ck, "group.json")) as f:
        g = json.load(f)
    assert g == {"tables": {"item": "table-item", "user": "table-user"}, "feature_map": FMAP,
                 "step": 4, "num_shards": S}
    run = JRunConfig(batch_size=64, pipeline_depth=0)
    j1 = JGroupTrainer(run, jax_tables(TABLES), FMAP, jax_model(WIDE))
    j1.load_checkpoint(ck)
    t1 = GroupTrainer(tc.RunConfig(batch_size=64),
                      {n: tc.TableConfig(**{**t, "optimizer": tc.OptimizerConfig(**t["optimizer"])})
                       for n, t in TABLES.items()}, FMAP,
                      tc.ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                                        for k, v in WIDE.items()}), device="cpu")
    t1.load_checkpoint(ck)
    assert t1.step == j1.step == 4
    for n in ("user", "item"):
        want = ranks_rows(ranks, n, TABLES[n]["dim"])
        assert_rows_equal(single_rows(t1.shards[n]), want, f"port {n}")
        assert_rows_equal(single_rows(j1.shards[n], j1.specs[n]), want, f"jax {n}")
    for j, p in enumerate(to_jax_params(t1.head)):
        np.testing.assert_array_equal(p, ranks[0][f"param{j}"])


def test_distributed_group_service_matches_jax(world):
    """GroupScoringService(distributed=True) on the JAX sharded checkpoint:
    each rank scores its 12 rows of 24, as the reference scores them."""
    ref, ranks = world["score"]
    np.testing.assert_allclose(cat(ranks, "scores"), ref["scores"], **TOL)
    assert [int(r["score_drops"]) for r in ranks] == [0, 0]
