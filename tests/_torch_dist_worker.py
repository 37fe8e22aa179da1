"""One rank of a gloo world running the port's row-sharded layer, for the
multi-rank parity tests (after tests/_mh_worker.py). It imports torch, numpy
and the port, never jax; caps torch at one thread; meets its peers through
a FileStore; and runs the cases of a JSON spec in order, each reading its
inputs from an npz and writing this rank's outputs to another.

Usage: python tests/_torch_dist_worker.py RANK WORLD STORE_FILE SPEC_JSON

SPEC_JSON: {"cases": [{"fn": <name below>, "in": <npz>, "out": <npz path
with "{rank}">, "args": {...}}, ...], "force_exchange": bool}. Config
arguments are the fields of the port's RunConfig, TableConfig (its
"optimizer" a dict of OptimizerConfig, "policy" of PolicyConfig) and
ModelConfig, as the JAX package's configs have them.
"""

import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from meepoembedding_tpu_torch.backends.host_kv import PyKVStore  # noqa: E402
from meepoembedding_tpu_torch.config import (  # noqa: E402
    ModelConfig,
    OptimizerConfig,
    PolicyConfig,
    RunConfig,
    TableConfig,
)
from meepoembedding_tpu_torch.ops import dedup  # noqa: E402
from meepoembedding_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from meepoembedding_tpu_torch.parallel import multihost  # noqa: E402
from meepoembedding_tpu_torch.parallel import ragged as rg  # noqa: E402
from meepoembedding_tpu_torch.parallel import sharded_table as st  # noqa: E402
from meepoembedding_tpu_torch.group_train import ShardedGroupTrainer  # noqa: E402
from meepoembedding_tpu_torch.parallel.colsharded import ColShardedTrainer  # noqa: E402
from meepoembedding_tpu_torch.parallel.trainer import ShardedTrainer  # noqa: E402
from meepoembedding_tpu_torch.serving_group import GroupScoringService  # noqa: E402
from meepoembedding_tpu_torch.serving_sharded import ShardedScoringService  # noqa: E402
from meepoembedding_tpu_torch.table import hashing, table_ops  # noqa: E402
from meepoembedding_tpu_torch.table.layout import TableSpec, alloc_shard  # noqa: E402
from meepoembedding_tpu_torch.tiering import SpillCodec  # noqa: E402
from meepoembedding_tpu_torch.weights import (  # noqa: E402
    from_jax_params,
    shard_from_stacked,
    stacked_from_shards,
    to_jax_params,
)


def table_config(args: dict) -> TableConfig:
    t = dict(args)
    if "optimizer" in t:
        t["optimizer"] = OptimizerConfig(**t["optimizer"])
    if "policy" in t:
        t["policy"] = PolicyConfig(**t["policy"])
    return TableConfig(**t)


def model_config(args: dict) -> ModelConfig:
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in args.items()})


def planes(shard, prefix="") -> dict:
    """The shard's planes as one rank of the reference's stacked layout."""
    out = {}
    for k, v in stacked_from_shards([shard]).items():
        if isinstance(v, list):
            for j, p in enumerate(v):
                out[f"{prefix}{k}{j}"] = p
        else:
            out[prefix + k] = v
    return out


def unstack(inp: dict, prefix: str) -> dict:
    """`planes` of every rank, stacked, back to `shard_from_stacked`'s dict."""
    st_ = {k[len(prefix):]: v for k, v in inp.items() if k.startswith(prefix)}
    for kind in ("opt_rowwise", "opt_fulldim"):
        keys = sorted((k for k in st_ if k.startswith(kind)), key=lambda k: int(k[len(kind):]))
        st_[kind] = [st_.pop(k) for k in keys]
    return st_


def exchange(mesh, inp, args):
    """Train lookups of `ids` [steps, S * n] (each rank its n), from the
    stacked state `init_*` when given, then a probe of `probe` [S * n]:
    owner, pos, ok and the rows of each step, the probe's rows, the shard."""
    spec = TableSpec.from_config(table_config(args["table"]), num_shards=mesh.size)
    shard = (shard_from_stacked(unstack(inp, "init_"), mesh.rank) if "init_key_hi" in inp
             else alloc_shard(spec, "cpu"))
    n = args["n"]
    ragged = args.get("ragged", False)
    cap = (rg.ragged_recv_cap(n, mesh.size, args["factor"]) if ragged
           else st.a2a_capacity(n, mesh.size, args["factor"]))
    out = {}

    def lookup(ids, step, train):
        hi, lo = hashing.split_ids_t(multihost.shard_batch(ids, mesh))
        uniq = dedup.unique_pairs(hi, lo, n)
        emb_u, ctx = st.exchange_lookup(spec, shard, uniq.hi, uniq.lo, uniq.valid, step, mesh,
                                        cap, train=train, ragged=ragged)
        return emb_u[uniq.inverse.long()], ctx

    for s, ids in enumerate(inp["ids"]):
        rows, ctx = lookup(ids, s + args.get("step0", 0), True)
        out[f"rows{s}"] = rows.numpy()
        if ragged:
            out[f"ok{s}"] = ctx.plan.ok.numpy()
        else:
            for k in ("owner", "pos", "ok"):
                out[f"{k}{s}"] = getattr(ctx, k).numpy()
    rows, ctx = lookup(inp["probe"], 0, False)
    out["probe_rows"] = rows.numpy()
    out["probe_drops"] = ctx.n_drop.numpy()
    out.update(planes(shard))
    return out


def _batch(inp, s, mesh):
    return {k: multihost.shard_batch(inp[k][s], mesh) for k in ("dense", "ids", "label")}


def trainer(mesh, inp, args):
    """`steps` train steps from the JAX params `p*` (with `maintenance_every`,
    maintenance into a per-rank PyKVStore every so many steps, and then a
    step of the `promote_*` batch followed by maintenance), then optionally
    an eval of batch `steps`, a `remove` of `remove_ids` and a save to
    `save`: the flushed losses, the shard, the params, counters, factors
    and the spill tier. With `grid` [S, C], a ColShardedTrainer on that
    grid of the world (each row shard's ranks read its rows; the cold tier
    on column 0)."""
    run = RunConfig(**args["run"])
    table = table_config(args["table"])
    model = model_config(args["model"])
    spill = None
    if "grid" in args:
        m2 = pmesh.make_mesh2d(*args["grid"], device="cpu")
        bmesh = m2.row
        if args.get("maintenance_every") and m2.col.rank == 0:
            spill = PyKVStore(SpillCodec(TableSpec.from_config(table, m2.S)).width)
        tr = ColShardedTrainer(run, table, model, m2, spill=spill, device="cpu")
    else:
        bmesh = mesh
        if args.get("maintenance_every"):
            spill = PyKVStore(SpillCodec(TableSpec.from_config(table, mesh.size)).width)
        tr = ShardedTrainer(run, table, model, mesh=mesh, spill=spill)
    from_jax_params(tr.model, [inp[f"p{j}"] for j in range(args["nparams"])])
    if "restore" in args:
        tr.load_checkpoint(args["restore"])
    returned, factors, evicted = [], [], []
    for s in range(args["steps"]):
        returned.append(tr.train_step(_batch(inp, s, bmesh))["loss"])
        factors.append(tr.a2a_factor)
        if args.get("maintenance_every") and (s + 1) % args["maintenance_every"] == 0:
            if tr._promoter is not None:  # the feeds so far staged, as on the JAX side
                tr._promoter.flush()
            evicted.append(tr.maintenance()["evicted"])
    out = {"losses": np.array([x for x in returned if x is not None]
                              + [loss for _, loss in tr.flush()]),
           "returned": np.array([np.nan if x is None else x for x in returned]),
           "factors": np.array(factors), "evicted": np.array(evicted)}
    if "promote_ids" in inp:  # spilled ids trained again come back at maintenance
        tr.train_step({k: multihost.shard_batch(inp[f"promote_{k}"], bmesh)
                       for k in ("dense", "ids", "label")})
        tr.flush()
        if tr._promoter is not None:
            tr._promoter.flush()
        m = tr.maintenance()
        out.update(promoted=m["promoted"], promote_evicted=m["evicted"])
    if spill is not None:
        out["spill_keys"] = np.array(sorted(spill._d), np.int64)
        out["spill_rows"] = np.array([spill._d[k] for k in sorted(spill._d)], np.float32)
    out["logits"] = tr.last_logits.numpy() if tr.last_logits is not None else np.zeros(0)
    if args.get("eval"):
        ev = tr.eval_step(_batch(inp, args["steps"], bmesh))
        out.update(eval_loss=ev["loss"], eval_logits=ev["logits"].numpy(),
                   eval_drops=ev["route_drops"])
    if "remove_ids" in inp:
        out["removed"] = tr.remove(inp["remove_ids"])
    if "save" in args:
        tr.save_checkpoint(args["save"], extras=args.get("extras"))
    c = tr.counters()
    out["ctr_values"] = np.array([c[k] for k in sorted(c)])
    out["ctr_names"] = np.array(sorted(c))
    out["rows"] = len(tr)
    out["capacity"] = tr.spec.capacity
    out["step"] = tr.step
    for j, p in enumerate(to_jax_params(tr.model)):
        out[f"param{j}"] = p
    out.update(planes(tr.shard))
    return out


def promote_one_shard(mesh, inp, args):
    """A ColShardedTrainer on the grid `grid` with a cold tier on column 0,
    whose row shard 0 alone has rows staged for promotion (`keys` with
    their `payload` in the cold tier's codec, put straight into its
    promoter); then maintenance() on every rank, and one train step of the
    batch `dense`/`ids`/`label` (each row shard its rows). Outputs the
    promotion figures, the rows and this rank's blocks of the keys after
    maintenance, and the live bound and capacity after the step."""
    run, table, model = (RunConfig(**args["run"]), table_config(args["table"]),
                         model_config(args["model"]))
    m2 = pmesh.make_mesh2d(*args["grid"], device="cpu")
    codec = SpillCodec(TableSpec.from_config(table, m2.S))
    spill = PyKVStore(codec.width) if m2.col.rank == 0 else None
    tr = ColShardedTrainer(run, table, model, m2, spill=spill, device="cpu")
    if spill is not None and m2.row.rank == 0:
        tr._promoter._staged.append((inp["keys"], inp["payload"]))
    m = tr.maintenance()
    hi, lo = hashing.split_ids_t(torch.from_numpy(inp["keys"]))
    pr = table_ops.probe(tr.spec_local, tr.shard, hi, lo, hashing.is_valid(hi, lo))
    out = {"promoted": m["promoted"], "staged": m["promote_staged"], "rows": len(tr),
           "found": pr.found.numpy(), "blocks": tr.shard.values[pr.slot.clamp(min=0).long()]
           .numpy()}
    tr.train_step(_batch(inp, 0, m2.row))
    tr.flush()
    return {**out, "live_upper": tr._live_upper, "capacity": tr.spec.capacity}


def serve(mesh, inp, args):
    """A ShardedScoringService on checkpoint `path`: this rank's scores of
    `dense`/`ids` (global arrays), its rows of `lookup_ids`, stats; with
    `http`, a POST /score and GET /healthz; with `reload`, a hot reload."""
    svc = ShardedScoringService(args["path"], table_config(args["table"]),
                                model_config(args["model"]), mesh=mesh,
                                a2a_factor=args.get("factor", 1.25))
    out = {"scores": svc.score(multihost.shard_batch(inp["dense"], mesh).numpy(),
                               multihost.shard_batch(inp["ids"], mesh).numpy())}
    out["rows"] = svc.lookup(multihost.shard_batch(inp["lookup_ids"], mesh).numpy()).numpy()
    out["len"] = len(svc)
    out["route_drops"] = svc.route_drops
    out["metrics"] = np.array(svc.metrics_text())
    if args.get("http"):
        out.update(http(svc, inp))
    if "reload" in args:
        out["reload_rows"] = svc.reload(args["reload"])["rows"]
    out.update(planes(svc.shard))
    return out


def _request(url: str, path: str, body=None):
    """(status, parsed reply) of a GET (no body) or a POST of `body` (bytes,
    or an object sent as JSON); /metrics replies with text."""
    data = None if body is None else (body if isinstance(body, bytes)
                                      else json.dumps(body).encode())
    try:
        with urllib.request.urlopen(urllib.request.Request(url + path, data=data),
                                    timeout=120) as r:
            code, text = r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        code, text = e.code, e.read().decode()
    return code, (text if path == "/metrics" else json.loads(text))


def front(mesh, inp, args):
    """One HTTP front over the world (`serving_sharded.LockstepFront`) on
    checkpoint `path`: a ShardedScoringService, or with `tables` a
    GroupScoringService(distributed=True). Rank 0 serves; a client thread
    of its own posts /score of each global batch `dense<i>`/`ids<i>`, and
    for one table looks `lookup_ids` up through `front.table`, reads
    /healthz and /metrics, posts a malformed body and one of `big_rows`
    rows, more than `max_rank_ids` (the front's bound) allow, then reloads
    `path` and a missing path, scoring batch 0 after each; with `items`, a
    RetrievalService over the front answers /retrieve of `query_dense` /
    `query_ids` at `k`. With `heartbeat`, the front's no-op interval, the
    client idles three of them after each batch. The client then stops
    the front. Every rank outputs the code its run or follow returned."""
    from meepoembedding_tpu_torch import serving_sharded
    from meepoembedding_tpu_torch.retrieval import RetrievalService
    from meepoembedding_tpu_torch.serving import make_http_server
    from meepoembedding_tpu_torch.serving_sharded import LockstepFront

    if "heartbeat" in args:
        serving_sharded._HEARTBEAT_S = args["heartbeat"]
    if "max_rank_ids" in args:
        serving_sharded.MAX_RANK_IDS = args["max_rank_ids"]

    model = model_config(args["model"])
    if "tables" in args:
        tables = {n: table_config(t) for n, t in args["tables"].items()}
        svc = GroupScoringService(args["path"], RunConfig(**args["run"]), tables, args["fmap"],
                                  model, distributed=True, mesh=mesh, device="cpu")
    else:
        svc = ShardedScoringService(args["path"], table_config(args["table"]), model,
                                    mesh=mesh, a2a_factor=args.get("factor", 1.25))
    fr = LockstepFront(svc, mesh)
    if mesh.rank:
        return {"rc": fr.follow()}
    ret = None
    if "items" in inp:
        ret = RetrievalService(fr)
        ret.build_index(inp["items"])
    server = make_http_server(fr, 0, retrieval=ret)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    out, failed = {}, []

    def request(path, body=None):
        return _request(url, path, body)

    def score(i):
        code, rep = request("/score", {"dense": inp[f"dense{i}"].tolist(),
                                       "ids": inp[f"ids{i}"].tolist()})
        assert code == 200, rep
        return np.array(rep["scores"], np.float32)

    def client():
        try:
            i = 0
            while f"dense{i}" in inp:
                out[f"scores{i}"] = score(i)
                i += 1
                if "heartbeat" in args:  # idle a while: rank 0 sends no-ops
                    time.sleep(3 * args["heartbeat"])
            out["health"] = json.dumps(request("/healthz")[1])
            out["metrics"] = request("/metrics")[1]
            if "lookup_ids" in inp:
                out["rows"] = fr.table.lookup(inp["lookup_ids"]).numpy()
                out["counters"] = json.dumps(fr.counters())
                out["bad_body"] = request("/score", b"{not json")[0]
                out["bad_shape"] = request("/score", {"dense": [[0.0]], "ids": [[1, 2]]})[0]
                out["after_bad"] = score(0)
                big = args["big_rows"]
                out["too_big"], rep = request("/score", {
                    "dense": np.zeros((big, model.num_dense_features)).tolist(),
                    "ids": np.ones((big, model.num_sparse_features), np.int64).tolist()})
                out["too_big_error"] = rep["error"]
                out["after_too_big"] = score(0)
                out["reload"] = json.dumps(request("/reload", {"ckpt": args["path"]}))
                code, rep = request("/reload", {"ckpt": args["path"] + "-missing"})
                out["bad_reload"], out["bad_reload_error"] = code, rep["error"]
                out["after_reload"] = score(0)
                out["health_after"] = json.dumps(request("/healthz")[1])
            if ret is not None:
                code, rep = request("/retrieve", {"dense": inp["query_dense"].tolist(),
                                                  "ids": inp["query_ids"].tolist(),
                                                  "k": int(args["k"])})
                assert code == 200, rep
                out["keys"] = np.array(rep["keys"], np.int64)
                out["retrieve_scores"] = np.array(rep["scores"], np.float32)
        except BaseException as e:  # handed to the main thread below
            failed.append(e)
        finally:
            fr.stop()

    th = threading.Thread(target=client)
    th.start()
    out["rc"] = fr.run(server)
    th.join(timeout=60)
    assert not th.is_alive()
    if failed:
        raise failed[0]
    return out


def http(svc, inp) -> dict:
    """One POST /score and GET /healthz through `serving.make_http_server`."""
    from meepoembedding_tpu_torch.serving import make_http_server

    server = make_http_server(svc, 0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        scores = _request(url, "/score", {"dense": inp["dense"][:5].tolist(),
                                          "ids": inp["ids"][:5].tolist()})[1]["scores"]
        health = _request(url, "/healthz")[1]
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=30)
    return {"http_scores": np.array(scores), "http_rows": health["rows"],
            "http_devices": health["devices"]}


def group(mesh, inp, args):
    """A ShardedGroupTrainer from the JAX head params `p*` (or, with
    `restore`, a checkpoint): `steps` steps (with `maintenance_every`,
    maintenance into per-member PyKVStores of the `spill` members, then a
    step of the `promote_*` batch and maintenance), an eval of batch
    `steps`, a `remove` of `remove_ids` from member `remove`, a save to
    `save`, and with `score` the scores of `score_*` by a distributed
    GroupScoringService on that checkpoint. Outputs the flushed losses,
    counters, params, every member's planes ("<name>." prefixed) and the
    cold tiers."""
    run = RunConfig(**args["run"])
    tables = {n: table_config(t) for n, t in args["tables"].items()}
    model = model_config(args["model"])
    spill = {n: PyKVStore(SpillCodec(TableSpec.from_config(tables[n], mesh.size)).width)
             for n in args.get("spill", [])}
    tr = ShardedGroupTrainer(run, tables, args["fmap"], model, mesh=mesh, spill=spill or None,
                             device="cpu")
    from_jax_params(tr.head, [inp[f"p{j}"] for j in range(args["nparams"])])
    if "restore" in args:
        tr.load_checkpoint(args["restore"])
    out, returned, evicted = {}, [], []
    every = args.get("maintenance_every", 0)
    for s in range(args["steps"]):
        returned.append(tr.train_step(_batch(inp, s, mesh))["loss"])
        if every and (s + 1) % every == 0:
            for prm in tr._promoters.values():
                prm.flush()
            m = tr.maintenance()
            evicted.append([m[n]["evicted"] for n in tr.names])
    out["losses"] = np.array([x for x in returned if x is not None]
                             + [loss for _, loss in tr.flush()])
    out["returned"] = np.array([np.nan if x is None else x for x in returned])
    out["evicted"] = np.array(evicted)
    if "promote_ids" in inp:
        tr.train_step({k: multihost.shard_batch(inp[f"promote_{k}"], mesh)
                       for k in ("dense", "ids", "label")})
        tr.flush()
        for prm in tr._promoters.values():
            prm.flush()
        m = tr.maintenance()
        out["promoted"] = np.array([m[n]["promoted"] for n in tr.names])
    if args.get("eval"):
        ev = tr.eval_step(_batch(inp, args["steps"], mesh))
        out.update(eval_loss=ev["loss"], eval_logits=ev["logits"].numpy(),
                   eval_drops=ev["route_drops"])
    if "remove_ids" in inp:
        out["removed"] = tr.remove(args["remove"], inp["remove_ids"])
    if "save" in args:
        tr.save_checkpoint(args["save"])
    if "score" in args:
        svc = GroupScoringService(args["score"], run, tables, args["fmap"], model,
                                  distributed=True, mesh=mesh, device="cpu")
        out["scores"] = svc.score(multihost.shard_batch(inp["score_dense"], mesh).numpy(),
                                  multihost.shard_batch(inp["score_ids"], mesh).numpy())
        out["score_drops"] = svc.route_drops
    c = tr.counters()
    names = sorted(c[tr.names[0]])
    out["ctr_names"] = np.array(names)
    out["ctr_values"] = np.array([[c[n][k] for k in names] for n in tr.names])
    out["step"] = tr.step
    for j, p in enumerate(to_jax_params(tr.head)):
        out[f"param{j}"] = p
    for n in tr.names:
        out.update(planes(tr.shards[n], prefix=f"{n}."))
        if n in spill:
            out[f"{n}.spill_keys"] = np.array(sorted(spill[n]._d), np.int64)
            out[f"{n}.spill_rows"] = np.array([spill[n]._d[k] for k in sorted(spill[n]._d)],
                                              np.float32).reshape(len(spill[n]._d), -1)
    return out


CASES = {"exchange": exchange, "trainer": trainer, "serve": serve, "group": group,
         "promote_one_shard": promote_one_shard, "front": front}


def main():
    rank, world, store, spec_path = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                     sys.argv[4])
    with open(spec_path) as f:
        spec = json.load(f)
    st.FORCE_EXCHANGE = bool(spec.get("force_exchange", False))
    pmesh.init_distributed("gloo", f"file://{store}", rank, world, device="cpu")
    mesh = pmesh.make_mesh(device="cpu")
    try:
        for c in spec["cases"]:
            with np.load(c["in"]) as z:
                inp = {k: z[k] for k in z.files}
            np.savez(c["out"].format(rank=rank), **CASES[c["fn"]](mesh, inp, c.get("args", {})))
    finally:
        pmesh.destroy()


if __name__ == "__main__":
    main()
