"""The port's column-sharded (row x dim) table against the JAX package's
`parallel/colsharded.py`: the port's side as gloo worlds of 4 (a 2 x 2
grid) and 2 (1 x 2) worker processes, the JAX side on `make_mesh2d` grids
of the conftest's virtual CPU devices, from the same numpy inputs.

Exact: the uniform and constant lane-offset inits, integer planes,
counters, the removed count, cold-tier keys, lockstep across columns, and
every restore (rows land by the same inserts). Within rtol 1e-5 / atol
1e-6 (`tests/_torch_dist_parity.py`): values, accumulators, losses,
logits and the cold tier's payloads; dense params within atol 1e-4. The
normal and truncated-normal inits within ERFINV_TOL (torch's erfinv and
JAX's differ in the last places)."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_dist_parity import (
    ADAGRAD,
    DIM,
    MODEL,
    SLOTS,
    TOL,
    assert_params_match,
    assert_stacked_match,
    batches,
    cat,
    jax_counters,
    jax_model,
    jax_table,
    params_inputs,
    port_counters,
    port_stacked,
    run_ranks,
)

from meepoembedding_tpu import checkpoint as jckpt
from meepoembedding_tpu.backends.host_kv import PyKVStore as JPyKVStore
from meepoembedding_tpu.config import RunConfig as JRunConfig
from meepoembedding_tpu.parallel import colsharded as jcol
from meepoembedding_tpu.parallel.mesh import make_mesh
from meepoembedding_tpu.parallel.trainer import ShardedTrainer as JShardedTrainer
from meepoembedding_tpu.table import hashing as jh
from meepoembedding_tpu.table import xla_ops as jx
from meepoembedding_tpu.table.layout import TableShard as JTableShard
from meepoembedding_tpu.table.layout import TableSpec as JTableSpec
from meepoembedding_tpu.tiering import SpillCodec as JSpillCodec
from meepoembedding_tpu.train import Trainer as JTrainer
from meepoembedding_tpu_torch.config import ModelConfig, RunConfig, TableConfig
from meepoembedding_tpu_torch.config import OptimizerConfig
from meepoembedding_tpu_torch.parallel.colsharded import col_local_spec
from meepoembedding_tpu_torch.table import hashing
from meepoembedding_tpu_torch.table.layout import TableSpec
from meepoembedding_tpu_torch.train import Trainer
from meepoembedding_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

ERFINV_TOL = dict(rtol=1e-5, atol=1e-6)
LOCKSTEP = ("key_hi", "key_lo", "cnt", "ovf", "freq", "last", "counters", "cms",
            "opt_rowwise0")
POLICY = {"evict_policy": "lfu_ttl", "ttl_steps": 1, "lfu_min_freq": 2,
          "max_evict_per_pass": 256, "evict_scan_buckets": 16}


def grid_case(S, C, seed, steps=4, batch=64, table_extra=None, bag=0, evaluate=True,
              remove=True, maintenance_every=0, restore=None, save=None):
    """Both packages' 2-D trainers on the same global batches: `steps` steps
    (maintenance and a promotion batch with `maintenance_every`), an eval
    and a `remove`. The JAX trainer holds the reference; the worker's case
    runs the port's on a gloo grid of S * C ranks."""
    run = dict(batch_size=batch, steps=max(steps, 1), seed=seed, pipeline_depth=0,
               dense_learning_rate=3e-3)
    table = {**dict(dim=DIM, capacity=SLOTS * S, optimizer=ADAGRAD), **(table_extra or {})}
    data = batches(seed, steps + 1, batch, bag=bag)
    spill = None
    if maintenance_every:
        spill = JPyKVStore(JSpillCodec(JTableSpec.from_config(jax_table(table), S)).width)
    jt = jcol.ColShardedTrainer(JRunConfig(**run), jax_table(table), jax_model(MODEL),
                                jcol.make_mesh2d(S, C), spill=spill)
    inputs = {**data, **params_inputs(jt)}
    if restore:
        jt.load_checkpoint(restore)
    ref = {"losses": [], "evicted": [], "trainer": jt,
           "init_params": [inputs[f"p{j}"] for j in range(len(params_inputs(jt)))]}
    for s in range(steps):
        ref["losses"].append(jt.train_step({k: v[s] for k, v in data.items()})["loss"])
        if spill is not None and (s + 1) % maintenance_every == 0:
            jt._promoter.flush()
            ref["evicted"].append(jt.maintenance()["evicted"])
    if spill is not None:
        keys = np.array(sorted(spill._d), np.int64)[:batch]
        promote = {k: v[steps].copy() for k, v in data.items()}
        promote["ids"][:len(keys), 0] = keys
        inputs.update({f"promote_{k}": v for k, v in promote.items()})
        jt.train_step(promote)
        jt.flush()
        jt._promoter.flush()
        m = jt.maintenance()
        ref.update(promoted=m["promoted"], promote_evicted=m["evicted"], spill=spill)
    if evaluate:
        ref["eval"] = jt.eval_step({k: v[steps] for k, v in data.items()})
    if remove:
        inputs["remove_ids"] = np.concatenate([data["ids"][0].reshape(-1)[:40], [-7, 12345]])
        ref["removed"] = jt.remove(inputs["remove_ids"])
    args = {"grid": [S, C], "run": run, "table": table, "model": MODEL,
            "nparams": len(params_inputs(jt)), "steps": steps, "eval": evaluate,
            "maintenance_every": maintenance_every}
    if restore:
        args["restore"] = restore
    if save:
        args["save"] = save
    return {"fn": "trainer", "inputs": inputs, "args": args}, ref


def check_grid(ref, ranks, S, C, what):
    """The port's grid against the JAX 2-D trainer of `grid_case`."""
    jt = ref["trainer"]
    if ref["losses"]:
        np.testing.assert_allclose(ranks[0]["losses"], ref["losses"], **TOL, err_msg=what)
    for r in ranks[1:]:  # every rank holds the global loss
        np.testing.assert_array_equal(r["losses"], ranks[0]["losses"])
    want = jax_counters(jt)
    assert {k: port_counters(ranks[0])[k] for k in want} == want, what
    # rank r = s * C + c: the ranks' planes in order are the JAX [S, C, ...]
    assert_stacked_match(jt.stacked, port_stacked(ranks), what=what)
    for r in ranks:
        assert_params_match(jt, r)
        assert int(r["rows"]) == len(jt)
    if "eval" in ref:
        np.testing.assert_allclose(ranks[0]["eval_loss"], ref["eval"]["loss"], **TOL)
        col0 = [ranks[s * C] for s in range(S)]
        np.testing.assert_allclose(cat(col0, "eval_logits"), np.asarray(ref["eval"]["logits"]),
                                   **TOL)
    if "removed" in ref:
        assert [int(r["removed"]) for r in ranks] == [ref["removed"]] * len(ranks)
        assert ref["removed"] > 0
    if "spill" in ref:  # column 0's cold tiers together hold the JAX one's rows
        np.testing.assert_array_equal(ranks[0]["evicted"], ref["evicted"])
        assert int(ranks[0]["promote_evicted"]) == ref["promote_evicted"]
        col0 = [ranks[s * C] for s in range(S)]
        # a rank reports its row shard's promotions, the same on each column
        assert sum(int(r["promoted"]) for r in col0) == ref["promoted"] > 0
        for s in range(S):
            assert len({int(ranks[s * C + c]["promoted"]) for c in range(C)}) == 1
        keys = np.concatenate([r["spill_keys"] for r in col0])
        rows = np.concatenate([r["spill_rows"] for r in col0])
        assert all("spill_keys" not in ranks[s * C + c] for s in range(S) for c in range(1, C))
        want_keys = sorted(ref["spill"]._d)
        o = np.argsort(keys)
        np.testing.assert_array_equal(keys[o], want_keys)
        np.testing.assert_allclose(rows[o], np.stack([ref["spill"]._d[k] for k in want_keys]),
                                   **TOL)


def merged_rows(ranks, S, C) -> dict:
    """id -> the full-dim row of the port's grid (its column blocks side by
    side), from the ranks' planes."""
    out = {}
    for s in range(S):
        r0 = ranks[s * C]
        hi, lo = r0["key_hi"].reshape(-1), r0["key_lo"].reshape(-1)
        live = ~((hi == jh.EMPTY_HI) & (lo == jh.EMPTY_LO))
        ids = hashing.join_ids(hi[live], lo[live])
        rows = np.concatenate([ranks[s * C + c]["values"].reshape(hi.shape[0], -1)[live]
                               for c in range(C)], axis=1)
        out.update(zip(ids.tolist(), rows))
    return out


def jax_planes_as_shard(rank: dict) -> JTableShard:
    """One rank's planes (the worker's `planes`) as a JAX TableShard."""
    def a(k):
        return jnp.asarray(rank[k][0])

    rw = sorted(k for k in rank if k.startswith("opt_rowwise"))
    fd = sorted(k for k in rank if k.startswith("opt_fulldim"))
    return JTableShard(key_hi=a("key_hi"), key_lo=a("key_lo"), cnt=a("cnt"), ovf=a("ovf"),
                       freq=a("freq"), last=a("last"), values=a("values"),
                       opt_rowwise=tuple(a(k) for k in rw), opt_fulldim=tuple(a(k) for k in fd),
                       counters=a("counters"), cms=a("cms"))


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """Every grid case of this file: the JAX references (and a JAX 2-D
    checkpoint), then one gloo world of 4 ranks and one of 2 running the
    port's side of all of them."""
    tmp = tmp_path_factory.mktemp("colsharded")
    ck_jax, ck_port = str(tmp / "ck_jax"), str(tmp / "ck_port")
    out = {"ck_jax": ck_jax, "ck_port": ck_port}
    train = grid_case(2, 2, seed=31, save=ck_port)
    train[1]["trainer"].save_checkpoint(ck_jax)
    restore_steps = dict(steps=0, remove=False)
    grid4 = {
        "train": train,
        "bags": grid_case(2, 2, seed=32, steps=3, bag=3, remove=False, evaluate=False,
                          table_extra={"grow_at_load": 0.5, "capacity": 1024}),
        "spill": grid_case(2, 2, seed=33, steps=6, remove=False, maintenance_every=2,
                           table_extra={"policy": POLICY}),
        "restore": grid_case(2, 2, seed=31, restore=ck_jax, **restore_steps),
        "restore_grow": grid_case(2, 2, seed=31, restore=ck_jax, **restore_steps,
                                  table_extra={"grow_at_load": 0.7, "capacity": 256}),
    }
    # row-sharded S = 2 restores the 2-D checkpoint too
    jrows = JShardedTrainer(JRunConfig(batch_size=64, pipeline_depth=0),
                            jax_table(dict(dim=DIM, capacity=SLOTS * 2, optimizer=ADAGRAD)),
                            jax_model(MODEL), mesh=make_mesh(2))
    jrows.load_checkpoint(ck_jax)
    rows_case = {"fn": "trainer", "inputs": params_inputs(jrows),
                 "args": {"run": dict(batch_size=64, pipeline_depth=0),
                          "table": dict(dim=DIM, capacity=SLOTS * 2, optimizer=ADAGRAD),
                          "model": MODEL, "nparams": len(params_inputs(jrows)), "steps": 0,
                          "restore": ck_jax}}
    grid2 = {
        "train12": grid_case(1, 2, seed=34),
        "restore12": grid_case(1, 2, seed=31, restore=ck_jax, **restore_steps),
        "restore_rows": (rows_case, {"trainer": jrows}),
    }
    for world, cases in ((4, grid4), (2, grid2)):
        ranks = run_ranks(tmp, world, [c for c, _ in cases.values()], timeout=180.0)
        out.update({name: (ref, r) for (name, (_, ref)), r in zip(cases.items(), ranks)})
    return out


# --- the lane-offset init and the block geometry -----------------------------

@pytest.mark.parametrize("kind", ["uniform", "constant", "normal", "truncated_normal"])
def test_lane_offset_init_matches_jax_and_tiles_full_dim(kind):
    rng = np.random.default_rng(3)
    ids = rng.integers(-10**15, 10**15, size=96, dtype=np.int64)
    hi, lo = hashing.split_ids(ids)
    th, tl = torch.from_numpy(hi), torch.from_numpy(lo)
    full = hashing.default_rows(th, tl, 64, 0.05, kind=kind).numpy()
    blocks = []
    for off in (0, 16, 32, 48):
        got = hashing.default_rows(th, tl, 16, 0.05, kind=kind, lane_offset=off).numpy()
        want = np.asarray(jh.default_rows(jnp.asarray(hi), jnp.asarray(lo), 16, 0.05,
                                          lane_offset=off, kind=kind))
        if kind in ("uniform", "constant"):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, **ERFINV_TOL)
        blocks.append(got)
    # the blocks of one package tile its full-dim init bit for bit
    np.testing.assert_array_equal(np.concatenate(blocks, axis=1), full)


def test_col_local_spec_geometry():
    table = TableConfig(dim=256, capacity=1 << 14, initializer_scale=0.02)
    spec = TableSpec.from_config(table, num_shards=2)
    for c in range(4):
        loc = col_local_spec(spec, 4, c)
        assert (loc.dim, loc.init_lane_offset) == (64, 64 * c)
        assert loc.num_buckets == spec.num_buckets and loc.capacity == spec.capacity
        jloc = jcol.col_local_spec(JTableSpec.from_config(jax_table({"dim": 256,
                                                                      "capacity": 1 << 14}), 2), 4)
        assert (jloc.dim, jloc.num_buckets) == (loc.dim, loc.num_buckets)
    with pytest.raises(ValueError, match="does not split"):
        col_local_spec(spec, 3)


# --- training on the grid ------------------------------------------------------

@pytest.mark.parametrize("name,S,C", [("train", 2, 2), ("train12", 1, 2)])
def test_grid_steps_match_jax(grids, name, S, C):
    ref, ranks = grids[name]
    check_grid(ref, ranks, S, C, name)


@pytest.mark.parametrize("name,S,C", [("train", 2, 2), ("train12", 1, 2), ("spill", 2, 2)])
def test_columns_stay_in_lockstep(grids, name, S, C):
    """Key and metadata planes, counters and the rowwise accumulator are
    bit-identical across the columns of a row shard; the values differ."""
    _, ranks = grids[name]
    for s in range(S):
        r0 = ranks[s * C]
        for c in range(1, C):
            for k in LOCKSTEP:
                np.testing.assert_array_equal(ranks[s * C + c][k], r0[k], err_msg=f"{s} {c} {k}")
            if r0["cnt"].sum():
                assert not np.array_equal(ranks[s * C + c]["values"], r0["values"])


def test_grid_matches_its_single_device_trainer(grids):
    """The port's 2 x 2 grid against the port's own single-device Trainer on
    the same global batches: losses and every row by id."""
    ref, ranks = grids["train"]
    run = RunConfig(batch_size=64, steps=4, seed=31, pipeline_depth=0, dense_learning_rate=3e-3)
    table = TableConfig(dim=DIM, capacity=SLOTS * 2,
                        optimizer=OptimizerConfig(**ADAGRAD))
    tr = Trainer(run, table, ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                                           for k, v in MODEL.items()}), device="cpu")
    from_jax_params(tr.model, ref["init_params"])
    data = batches(31, 5, 64)
    losses = [tr.train_step({k: v[s] for k, v in data.items()})["loss"] for s in range(4)]
    np.testing.assert_allclose(ranks[0]["losses"], losses, **TOL)
    # the grid's rows are those after its remove of the first 40 ids
    removed = set(data["ids"][0].reshape(-1)[:40].tolist())
    grid = merged_rows(ranks, 2, 2)
    hi, lo = tr.shard.key_hi.numpy().reshape(-1), tr.shard.key_lo.numpy().reshape(-1)
    live = ~((hi == jh.EMPTY_HI) & (lo == jh.EMPTY_LO))
    single = dict(zip(hashing.join_ids(hi[live], lo[live]).tolist(),
                      tr.shard.values.numpy()[live]))
    assert removed <= set(single) and set(grid) == set(single) - removed
    ids = sorted(grid)
    np.testing.assert_allclose(np.stack([grid[i] for i in ids]),
                               np.stack([single[i] for i in ids]), **TOL)


def test_grid_bags_and_growth_match_jax(grids):
    ref, ranks = grids["bags"]
    assert ref["trainer"].spec.capacity > 512  # both grew
    check_grid(ref, ranks, 2, 2, "bags")
    assert int(ranks[0]["capacity"]) == ref["trainer"].spec.capacity


def test_grid_spill_and_promotion_match_jax(grids):
    """LFU/TTL eviction: column 0 spills full-dim rows, the same the JAX
    trainer spills; spilled ids trained again come back at maintenance."""
    ref, ranks = grids["spill"]
    assert sum(ref["evicted"]) > 0
    check_grid(ref, ranks, 2, 2, "spill")


# --- checkpoints, both ways ------------------------------------------------------

def test_port_2d_save_reads_in_jax(grids, tmp_path):
    """The port's 2 x 2 save: JAX's iter_rows merges its blocks into the
    grid's rows bit for bit; its part files hold the arrays the JAX writer
    writes for the same planes; the JAX trainers restore it."""
    ref, ranks = grids["train"]
    ck = grids["ck_port"]
    m = jckpt.read_manifest(ck)
    assert (m["col_shards"], m["num_shards"], m["dim"], m["step"]) == (2, 2, DIM, 4)
    parts = list(jckpt.iter_rows(ck))
    ids = np.concatenate([p["ids"] for p in parts])
    vals = np.concatenate([p["values"] for p in parts])
    grid = merged_rows(ranks, 2, 2)
    assert sorted(ids.tolist()) == sorted(grid)
    np.testing.assert_array_equal(vals, np.stack([grid[i] for i in ids.tolist()]))
    # the JAX writer on the port's planes writes the same arrays
    jt = jcol.ColShardedTrainer(JRunConfig(batch_size=64, pipeline_depth=0),
                                jax_table(dict(dim=DIM, capacity=SLOTS * 2, optimizer=ADAGRAD)),
                                jax_model(MODEL), jcol.make_mesh2d(2, 2))
    jt.stacked = jcol.stacked_from_shards2(
        {(s, c): jax_planes_as_shard(ranks[s * 2 + c]) for s in range(2) for c in range(2)},
        jt.mesh, jt.stacked)
    jt.step = 4
    jt.save_checkpoint(str(tmp_path / "jax_writer"))
    for f in sorted(glob.glob(os.path.join(ck, "step-*", "shard-*.npz"))):
        other = glob.glob(os.path.join(tmp_path, "jax_writer", "step-*",
                                       os.path.basename(f)))
        with np.load(f) as a, np.load(other[0]) as b:
            assert sorted(a.files) == sorted(b.files), f
            for k in a.files:
                assert a[k].dtype == b[k].dtype, (f, k)
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{f} {k}")
    # restored by the JAX 2-D trainer and its single-device trainer
    j2 = jcol.ColShardedTrainer(JRunConfig(batch_size=64, pipeline_depth=0),
                                jax_table(dict(dim=DIM, capacity=SLOTS * 2, optimizer=ADAGRAD)),
                                jax_model(MODEL), jcol.make_mesh2d(2, 2))
    j2.load_checkpoint(ck)
    assert len(j2) == len(grid) and j2.step == 4
    j1 = JTrainer(JRunConfig(batch_size=64, pipeline_depth=0),
                  jax_table(dict(dim=DIM, capacity=SLOTS * 2, optimizer=ADAGRAD)),
                  jax_model(MODEL))
    j1.load_checkpoint(ck)
    slots = jnp.arange(j1.spec.capacity, dtype=jnp.int32)
    got = np.asarray(jx.gather_values(j1.spec, j1.shard.values, slots))
    hi, lo = np.asarray(j1.shard.key_hi).reshape(-1), np.asarray(j1.shard.key_lo).reshape(-1)
    live = ~((hi == jh.EMPTY_HI) & (lo == jh.EMPTY_LO))
    jids = hashing.join_ids(hi[live], lo[live]).tolist()
    np.testing.assert_array_equal(got[live], np.stack([grid[i] for i in jids]))


@pytest.mark.parametrize("name,S,C", [("restore", 2, 2), ("restore_grow", 2, 2),
                                      ("restore12", 1, 2), ("restore_rows", 2, 1)])
def test_jax_2d_checkpoint_restores_on_the_port(grids, name, S, C):
    """A JAX `save_sharded2d` checkpoint restored by the port on a 2 x 2
    grid (also into a smaller growable table, which pre-grows), a 1 x 2
    grid and S = 2 row shards: every plane equal to the JAX trainers'
    restores of it."""
    ref, ranks = grids[name]
    jt = ref["trainer"]
    assert_stacked_match(jt.stacked, port_stacked(ranks), exact=True, what=name)
    for r in ranks:
        assert int(r["step"]) == jt.step and int(r["rows"]) == len(jt) > 0
        assert_params_match(jt, r)
    if name == "restore_grow":
        assert jt.spec.capacity > 256 and int(ranks[0]["capacity"]) == jt.spec.capacity
    if "eval" in ref:
        np.testing.assert_allclose(ranks[0]["eval_loss"], ref["eval"]["loss"], **TOL)


def test_jax_2d_checkpoint_restores_on_one_device(grids):
    ck = grids["ck_jax"]
    table = dict(dim=DIM, capacity=SLOTS * 2, optimizer=ADAGRAD)
    j1 = JTrainer(JRunConfig(batch_size=64, pipeline_depth=0), jax_table(table),
                  jax_model(MODEL))
    j1.load_checkpoint(ck)
    tr = Trainer(RunConfig(batch_size=64, pipeline_depth=0),
                 TableConfig(dim=DIM, capacity=SLOTS * 2, optimizer=OptimizerConfig(**ADAGRAD)),
                 ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                                for k, v in MODEL.items()}), device="cpu")
    tr.load_checkpoint(ck)
    assert tr.step == j1.step == 4
    for n in ("key_hi", "key_lo", "cnt", "ovf", "freq", "last", "counters"):
        np.testing.assert_array_equal(getattr(tr.shard, n).numpy(),
                                      np.asarray(getattr(j1.shard, n)), err_msg=n)
    slots = jnp.arange(j1.spec.capacity, dtype=jnp.int32)
    np.testing.assert_array_equal(tr.shard.values.numpy(),
                                  np.asarray(jx.gather_values(j1.spec, j1.shard.values, slots)))
    np.testing.assert_array_equal(tr.shard.opt_rowwise[0].numpy(),
                                  np.asarray(j1.shard.opt_rowwise[0]))


def test_promotion_staged_on_one_row_shard_keeps_the_grid_in_step(tmp_path):
    """maintenance() on a 2 x 2 grid whose row shard 0 alone has rows staged
    for promotion (put straight into its column-0 promoter, so no race
    decides it). Every rank must make the row mesh's sum of the inserted
    rows, whether or not its row shard drained any: a rank that skips it
    leaves the grid at different collectives (gloo's collective mismatch,
    or a wait until the worker's short timeout), and must add the sum to its
    bound on the live rows, so that the next step's growth check (its
    grow_at_load just above the step's incoming ids, below them plus the
    promoted rows) makes the same collectives on every rank. The staged
    rows land in both columns of row shard 0, each column its block of the
    payload; the step grows every shard once."""
    from meepoembedding_tpu_torch.tiering import SpillCodec

    S, C, n = 2, 2, 40
    batch = 64
    incoming = batch * MODEL["num_sparse_features"]  # the step's ids, every row shard's
    grow_at_load = (incoming + n / 2) / (SLOTS * S)
    table = {"dim": DIM, "capacity": SLOTS * S, "optimizer": ADAGRAD,
             "grow_at_load": grow_at_load}
    rng = np.random.default_rng(35)
    ids = rng.integers(1, 10**15, size=4 * n, dtype=np.int64)
    hi, lo = hashing.split_ids_t(torch.from_numpy(ids))
    keys = ids[hashing.owner_of(hi, lo, S).numpy() == 0][:n]
    assert len(keys) == n
    codec = SpillCodec(TableSpec.from_config(TableConfig(
        dim=DIM, capacity=SLOTS * S, optimizer=OptimizerConfig(**ADAGRAD)), S))
    values = rng.standard_normal((n, DIM)).astype(np.float32)
    accum = rng.random(n).astype(np.float32)
    payload = codec.pack(values, np.full(n, 3, np.int32), accum)
    step = {"dense": rng.standard_normal((1, batch, MODEL["num_dense_features"]))
            .astype(np.float32),
            "ids": rng.integers(1, 10**15, size=(1, batch, MODEL["num_sparse_features"]),
                                dtype=np.int64),
            "label": rng.integers(0, 2, size=(1, batch)).astype(np.float32)}
    case = {"fn": "promote_one_shard", "inputs": {"keys": keys, "payload": payload, **step},
            "args": {"grid": [S, C], "table": table, "model": MODEL,
                     "run": dict(batch_size=batch, steps=1, seed=35, pipeline_depth=0)}}
    (ranks,) = run_ranks(tmp_path, S * C, [case], timeout=60)
    assert [int(r["promoted"]) for r in ranks] == [n, n, 0, 0]
    assert [int(r["rows"]) for r in ranks] == [n] * 4
    d = DIM // C
    for c in range(C):
        assert ranks[c]["found"].all()
        np.testing.assert_array_equal(ranks[c]["blocks"], values[:, c * d:(c + 1) * d])
    assert not any(ranks[S + c]["found"].any() for c in range(C))
    assert [int(r["live_upper"]) for r in ranks] == [n + incoming] * 4
    assert [int(r["capacity"]) for r in ranks] == [2 * SLOTS] * 4  # a shard's slots
