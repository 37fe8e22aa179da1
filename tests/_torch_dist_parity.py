"""Shared by the multi-rank parity tests of the port's row-sharded layer: the
launcher of gloo worlds (`tests/_torch_dist_worker.py`, one process a
rank, each with its own timeout), and the JAX package's side of each case
on a mesh of S of the 8 virtual CPU devices that `tests/conftest.py` gives.

Both sides start from the same numpy inputs and the same configs (the
field names of the two packages' configs are the same). Exact: owner,
pos, ok, the rows of an exchange, integer planes and counters. Within
rtol 1e-5 / atol 1e-6: values, accumulators, losses, logits and scores
(a bf16 table's values: BF16_TOL below); dense params within atol 1e-4
(one Adam step moves a weight by up to lr whatever the size of its
gradient)."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
from jax.sharding import PartitionSpec as P

from meepoembedding_tpu.backends.host_kv import PyKVStore as JPyKVStore
from meepoembedding_tpu.config import ModelConfig as JModelConfig
from meepoembedding_tpu.config import OptimizerConfig as JOptimizerConfig
from meepoembedding_tpu.config import PolicyConfig as JPolicyConfig
from meepoembedding_tpu.config import RunConfig as JRunConfig
from meepoembedding_tpu.config import TableConfig as JTableConfig
from meepoembedding_tpu.ops import dedup as jdedup
from meepoembedding_tpu.parallel import ragged as jrg
from meepoembedding_tpu.parallel import sharded_table as jst
from meepoembedding_tpu.parallel.mesh import SHARD_AXIS, make_mesh
from meepoembedding_tpu.parallel.trainer import ShardedTrainer as JShardedTrainer
from meepoembedding_tpu.parallel.trainer import alloc_stacked_shards
from meepoembedding_tpu.table import hashing as jh
from meepoembedding_tpu.table.layout import TableSpec as JTableSpec
from meepoembedding_tpu.tiering import SpillCodec as JSpillCodec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_dist_worker.py")
TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=0.0, atol=1e-4)
INT_PLANES = ("key_hi", "key_lo", "cnt", "ovf", "freq", "last", "counters", "cms")

# the sizes of these tests: dim 16, 2^12 slots a shard, 4 sparse features
DIM, SLOTS, NSPARSE = 16, 1 << 12, 4
MODEL = dict(num_dense_features=4, num_sparse_features=NSPARSE, embedding_dim=DIM,
             bottom_mlp=[16, DIM], top_mlp=[16, 1])


def table_args(S: int, **kw) -> dict:
    return {"dim": DIM, "capacity": SLOTS * S, **kw}


# --- the port's side: gloo worlds of worker processes ---------------------------

def run_ranks(tmp_path, S: int, cases: list, force_exchange: bool = False,
              timeout: float = 150.0) -> list:
    """Run `cases` ({"fn", "args", "inputs": dict of arrays}) on a world of S
    worker processes; returns, per case, the ranks' output dicts. Every
    process is killed when the timeout runs out."""
    d = tmp_path / f"world{S}-{len(os.listdir(tmp_path))}"
    d.mkdir()
    spec = {"force_exchange": force_exchange, "cases": []}
    for i, c in enumerate(cases):
        np.savez(d / f"in{i}.npz", **c.get("inputs", {}))
        spec["cases"].append({"fn": c["fn"], "args": c.get("args", {}),
                              "in": str(d / f"in{i}.npz"), "out": str(d / f"out{i}-{{rank}}.npz")})
    (d / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(S), str(d / "store"),
                               str(d / "spec.json")], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
             for r in range(S)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} of {S} failed:\n{errs[r][-4000:]}"
    out = []
    for i in range(len(cases)):
        ranks = []
        for r in range(S):
            with np.load(d / f"out{i}-{r}.npz") as z:
                ranks.append({k: z[k] for k in z.files})
        out.append(ranks)
    return out


def cat(ranks: list, key: str) -> np.ndarray:
    """One output of every rank, in rank order, along axis 0."""
    return np.concatenate([np.atleast_1d(r[key]) for r in ranks])


def port_stacked(ranks: list) -> dict:
    """The ranks' planes (`_torch_dist_worker.planes`) stacked [S, ...]."""
    return {k: np.concatenate([r[k] for r in ranks]) for k in ranks[0]
            if k.startswith(("key_", "cnt", "ovf", "freq", "last", "counters", "cms",
                             "values", "opt_"))}


def jax_stacked(stacked) -> dict:
    """A JAX stacked shard's planes by the worker's names, bf16 as bits."""
    def host(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a

    out = {n: host(getattr(stacked, n)) for n in INT_PLANES + ("values",)}
    for kind in ("opt_rowwise", "opt_fulldim"):
        for j, p in enumerate(getattr(stacked, kind)):
            out[f"{kind}{j}"] = host(p)
    return out


# A bf16 row is rounded after an f32 update whose last place may differ (the
# reference's rowwise accumulator sums g^2 over 128 window lanes, the port's
# over dim lanes), so a rounding may land one bf16 unit (2^-8 relative)
# apart, once a step: within 4 units over the tests' 3 steps.
BF16_TOL = dict(rtol=2.0**-6, atol=1e-6)


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << np.uint32(16)).view(np.float32)


def assert_stacked_match(jax_st, port_st: dict, exact: bool = False, what: str = ""):
    """Integer planes exact; value-like planes exact, or within TOL (f32)
    or BF16_TOL (bf16 planes, compared as their f32 values)."""
    j = jax_stacked(jax_st)
    assert set(j) == set(port_st), (what, sorted(j), sorted(port_st))
    for n in j:
        a, b = j[n], port_st[n].reshape(j[n].shape)
        if n in INT_PLANES or exact:
            np.testing.assert_array_equal(b, a, err_msg=f"{what} {n}")
        elif a.dtype == np.uint16:
            np.testing.assert_allclose(_bf16_bits_to_f32(b), _bf16_bits_to_f32(a), **BF16_TOL,
                                       err_msg=f"{what} {n}")
        else:
            np.testing.assert_allclose(b, a, **TOL, err_msg=f"{what} {n}")


def init_inputs(stacked) -> dict:
    """A JAX stacked shard as the worker's `init_*` inputs."""
    return {f"init_{k}": v for k, v in jax_stacked(stacked).items()}


# --- the JAX package's side ------------------------------------------------------

def jax_table(args: dict) -> JTableConfig:
    t = dict(args)
    if "optimizer" in t:
        t["optimizer"] = JOptimizerConfig(**t["optimizer"])
    if "policy" in t:
        t["policy"] = JPolicyConfig(**t["policy"])
    return JTableConfig(**t)


def jax_model(args: dict) -> JModelConfig:
    return JModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in args.items()})


def jax_exchange(S: int, table: dict, n: int, factor: float, ids_steps, probe_ids,
                 ragged: bool = False, stacked=None, step0: int = 0):
    """The JAX exchange on a mesh of S: train lookups of each step's ids,
    then a probe. Returns (per-step dicts of rows/owner/pos/ok, probe rows,
    probe drops, the stacked shard)."""
    mesh = make_mesh(S)
    spec = JTableSpec.from_config(jax_table(table), num_shards=S)
    stacked = alloc_stacked_shards(spec, mesh) if stacked is None else stacked
    cap = (jrg.ragged_recv_cap(n, S, factor) if ragged else jst.a2a_capacity(n, S, factor))

    def make(train):
        def impl(stacked, hi, lo, step):
            shard = jst.squeeze_shard(stacked)
            uniq = jdedup.unique_pairs(hi, lo, n)
            d0 = shard.counters[jst.ROUTE_DROPS]
            shard2, emb_u, ctx = jst.exchange_lookup(spec, shard, uniq.hi, uniq.lo, uniq.valid,
                                                     step, SHARD_AXIS, cap, train=train,
                                                     ragged=ragged)
            drops = jax.lax.psum(shard2.counters[jst.ROUTE_DROPS] - d0, SHARD_AXIS)
            if ragged:
                route = (ctx.plan.ok, ctx.plan.ok, ctx.plan.ok)
            else:
                route = (ctx.owner, ctx.pos, ctx.ok)
            return jst.unsqueeze_shard(shard2), emb_u[uniq.inverse], route, drops

        sp = P(SHARD_AXIS)
        return jax.jit(jax.shard_map(impl, mesh=mesh, in_specs=(sp, sp, sp, P()),
                                     out_specs=(sp, sp, (sp, sp, sp), P()), check_vma=False))

    train_fn, probe_fn = make(True), make(False)
    steps = []
    for s, ids in enumerate(ids_steps):
        hi, lo = jh.split_ids(ids)
        stacked, rows, (owner, pos, ok), _ = train_fn(stacked, jnp.asarray(hi), jnp.asarray(lo),
                                                      jnp.int32(step0 + s))
        steps.append({"rows": np.asarray(rows), "owner": np.asarray(owner),
                      "pos": np.asarray(pos), "ok": np.asarray(ok)})
    hi, lo = jh.split_ids(probe_ids)
    _, rows, _, drops = probe_fn(stacked, jnp.asarray(hi), jnp.asarray(lo), jnp.int32(0))
    return steps, np.asarray(rows), int(drops), stacked


def batches(seed: int, steps: int, batch: int, vocab: int = 3000, bag: int = 0) -> dict:
    """Global batches [steps, B, ...] of random ids, dense features and
    labels from a numpy seed (ids: `vocab` values a feature, some large)."""
    rng = np.random.default_rng(seed)
    shape = (steps, batch, NSPARSE) + ((bag,) if bag else ())
    ids = rng.integers(0, vocab, size=shape, dtype=np.int64) * 7919 + 1
    ids += np.arange(NSPARSE, dtype=np.int64).reshape((1, 1, NSPARSE) + (1,) * bool(bag)) << 40
    return {"dense": rng.standard_normal((steps, batch, 4)).astype(np.float32),
            "ids": ids, "label": (rng.random((steps, batch)) < 0.3).astype(np.float32)}


def jax_trainer(S: int, run: dict, table: dict, model: dict = MODEL):
    return JShardedTrainer(JRunConfig(**run), jax_table(table), jax_model(model),
                           mesh=make_mesh(S))


def params_inputs(jt) -> dict:
    leaves = jax.tree_util.tree_leaves(jt.params)
    return {f"p{j}": np.asarray(x) for j, x in enumerate(leaves)}


def jax_params(jt) -> list:
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(jt.params)]


def assert_params_match(jt, rank: dict):
    leaves = jax_params(jt)
    for j, a in enumerate(leaves):
        np.testing.assert_allclose(rank[f"param{j}"], a, **PARAM_TOL, err_msg=f"param {j}")


def jax_counters(jt) -> dict:
    return {k: v for k, v in jt.counters().items()}


def port_counters(rank: dict) -> dict:
    return dict(zip((str(n) for n in rank["ctr_names"]), (int(v) for v in rank["ctr_values"])))


# --- cases run on both sides ------------------------------------------------------

ADAGRAD = {"kind": "rowwise_adagrad", "learning_rate": 0.1}


def rand_ids(rng, steps, S, n, vocab=2000):
    """[steps, S * n] ids of `vocab` values, spread over 10^15."""
    return rng.integers(1, vocab, size=(steps, S * n), dtype=np.int64) * 2654435761 % 10**15


def exchange_case(S, n, factor, seed, ragged=False):
    """Both sides' lookups: JAX runs step 0 alone, the port starts from its
    state (the stacked converter), both run steps 1-2 and a probe."""
    rng = np.random.default_rng(seed)
    ids = rand_ids(rng, 3, S, n)
    probe = np.concatenate([ids[1][: S * n // 2], rand_ids(rng, 1, S, n // 2, vocab=10**6)[0]])
    table = table_args(S, optimizer=ADAGRAD)
    _, _, _, state0 = jax_exchange(S, table, n, factor, ids[:1], probe, ragged=ragged)
    steps, probe_rows, probe_drops, stacked = jax_exchange(S, table, n, factor, ids[1:], probe,
                                                           ragged=ragged, stacked=state0, step0=1)
    case = {"fn": "exchange", "args": {"table": table, "n": n, "factor": factor, "step0": 1,
                                       "ragged": ragged},
            "inputs": {"ids": ids[1:], "probe": probe, **init_inputs(state0)}}
    return case, (steps, probe_rows, probe_drops, stacked)


def trainer_case(S, seed, steps=3, batch=64, factor=1.25, extra_run=None, table_extra=None,
                 evaluate=True, remove=True, maintenance_every=0):
    """`steps` ShardedTrainer steps of both packages from the JAX tower, then
    an eval of one more batch and a `remove` of some trained ids. With
    `maintenance_every`, maintenance into a python spill tier every so many
    steps, then a batch holding spilled ids and one more maintenance, which
    promotes them."""
    run = dict(batch_size=batch, steps=steps, seed=seed, pipeline_depth=0,
               dense_learning_rate=3e-3, a2a_factor=factor, **(extra_run or {}))
    table = table_args(S, optimizer=ADAGRAD, **(table_extra or {}))
    data = batches(seed, steps + 1, batch)
    spill = None
    if maintenance_every:
        spill = JPyKVStore(JSpillCodec(JTableSpec.from_config(jax_table(table), S)).width)
    jt = JShardedTrainer(JRunConfig(**run), jax_table(table), jax_model(MODEL),
                         mesh=make_mesh(S), spill=spill)
    inputs = {**data, **params_inputs(jt)}
    ref = {"losses": [], "factors": [], "evicted": []}
    for s in range(steps):
        ref["losses"].append(jt.train_step({k: v[s] for k, v in data.items()})["loss"])
        ref["factors"].append(jt.a2a_factor)
        if spill is not None and (s + 1) % maintenance_every == 0:
            # promotion is asynchronous: both sides wait for their promoter's
            # worker before a tick, so the same rows are staged at it
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
    ref["trainer"] = jt
    case = {"fn": "trainer", "inputs": inputs,
            "args": {"run": run, "table": table, "model": MODEL, "nparams": len(params_inputs(jt)),
                     "steps": steps, "eval": evaluate, "maintenance_every": maintenance_every}}
    return case, ref


def check_trainer(ref, ranks, what):
    """The port's ranks against the JAX trainer of `trainer_case`."""
    jt = ref["trainer"]
    np.testing.assert_allclose(ranks[0]["losses"], ref["losses"], **TOL, err_msg=what)
    for r in ranks[1:]:  # every rank holds the global loss
        np.testing.assert_array_equal(r["losses"], ranks[0]["losses"])
    np.testing.assert_array_equal(ranks[0]["factors"], ref["factors"])
    assert port_counters(ranks[0]) == jax_counters(jt), (what, port_counters(ranks[0]),
                                                        jax_counters(jt))
    assert_stacked_match(jt.stacked, port_stacked(ranks), what=what)
    for r in ranks:
        assert_params_match(jt, r)
    if "eval" in ref:
        ev = ref["eval"]
        np.testing.assert_allclose(ranks[0]["eval_loss"], ev["loss"], **TOL)
        np.testing.assert_allclose(cat(ranks, "eval_logits"), np.asarray(ev["logits"]), **TOL)
        assert int(ranks[0]["eval_drops"]) == ev["route_drops"]
    if "removed" in ref:
        assert int(ranks[0]["removed"]) == ref["removed"] > 0
    assert int(ranks[0]["rows"]) == len(jt)
    assert int(ranks[0]["capacity"]) == jt.spec.capacity
    if "spill" in ref:  # the ranks' spill tiers together hold the JAX one's rows
        np.testing.assert_array_equal(ranks[0]["evicted"], ref["evicted"])
        assert int(ranks[0]["promote_evicted"]) == ref["promote_evicted"]
        assert sum(int(r["promoted"]) for r in ranks) == ref["promoted"] > 0
        keys = np.concatenate([r["spill_keys"] for r in ranks])
        rows = np.concatenate([r["spill_rows"] for r in ranks])
        want = sorted(ref["spill"]._d)
        o = np.argsort(keys)
        np.testing.assert_array_equal(keys[o], want)
        np.testing.assert_allclose(rows[o], np.stack([ref["spill"]._d[k] for k in want]), **TOL)
