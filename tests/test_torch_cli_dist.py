"""The port's `--distributed` command line over a world of 2 gloo ranks:
each rank is a `python -m meepoembedding_tpu_torch ... --device cpu`
process that meets the other through torchrun's environment (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), reads its own lines of
the Criteo file (i % 2 == rank, half of each global batch) and is killed at
its timeout, with its traceback in the assertion message. The sharded
trainer itself is held against the JAX package in `test_torch_sharded.py`;
here the front end:

- `train --distributed` prints on rank 0 only, and the 2-shard checkpoint
  it writes holds, by `ckpt-inspect`, the rows its last log line counts;
- `eval --distributed` over the 2 ranks gives the single-device `eval` of
  that checkpoint: examples exact, AUC within 1e-9 (the same logits in
  the same bins), mean loss within rtol 1e-5 (a mean of the ranks' means);
- `serve --distributed` prints rank 0's and rank 1's scores of each global
  batch, equal within rtol 1e-5 / atol 1e-6 to the single-device scores of
  those lines; with `--http`, rank 0's POST /score of a global batch equals
  the single-device ScoringService's, SIGINT to rank 0 stops both, and
  a killed rank 1 makes rank 0 exit non-zero at its next request;
- `train --distributed --col-shards 2` on a world of 4 (a 2 x 2 grid):
  rank 0 prints; its 2-D checkpoint holds the rows the port's
  single-device Trainer trains on the same global batches (ids, freq and
  last exact, values and accumulators within rtol 1e-5 / atol 1e-6: the
  grid sums a batch's terms in another order); with --spill host it
  evicts and spills from column 0; --col-shards must divide the world."""

import dataclasses
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from _torch_cli_parity import (
    TOL,
    call,
    free_port,
    http_world,
    json_lines,
    post,
    rows_by_id,
    run_world,
    start_rank,
    wait_healthy,
    world_env,
)

from meepoembedding_tpu_torch import cli as tcli
from meepoembedding_tpu_torch.data.criteo import write_synthetic_criteo
from meepoembedding_tpu_torch.train import Trainer

torch.set_num_threads(1)

S = 2
# Criteo's 13 dense and 26 sparse columns, dim 16, 2^16 slots over the ranks
SETS = ["run.batch_size=256", "table.capacity=65536", "table.dim=16",
        "model.num_sparse_features=26", "model.num_dense_features=13",
        "model.bottom_mlp=32,16", "model.top_mlp=32,1"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the Criteo file, the 2-shard checkpoint, the ranks' outputs) of a
    6-step `train --distributed` on 1,024 Criteo lines."""
    d = tmp_path_factory.mktemp("world")
    data, ck = str(d / "day.tsv"), str(d / "ck")
    write_synthetic_criteo(data, 1024, seed=4)
    outs = run_world(["train", "--distributed", "--data", data, "--ckpt-dir", ck, "--set",
                      "run.steps=6", "run.log_every=3", "run.eval_every=3", *SETS])
    return data, ck, outs


def test_train_prints_on_rank_zero_only(world):
    _, _, outs = world
    assert outs[1][1] == ""
    lines = json_lines(outs[0][1])
    assert lines[-1]["steps"] == 6 and 0.0 <= lines[-1]["final_auc"] <= 1.0
    logs = [x for x in lines if "loss" in x]
    evals = [x for x in lines if "eval_loss" in x]
    assert [x["step"] for x in logs] == [3, 6] and [x["step"] for x in evals] == [3, 6]
    assert logs[-1]["route_drops"] == 0 and logs[-1]["drops"] == 0


def test_checkpoint_counts_sum_to_the_rows(world):
    _, ck, outs = world
    rc, out, _ = call(tcli.main, ["ckpt-inspect", ck, "--device", "cpu"])
    m = json.loads(out)
    rows = [x for x in json_lines(outs[0][1]) if "rows" in x][-1]["rows"]
    assert rc == 0 and m["num_shards"] == S and m["step"] == 6
    assert sum(m["counts"]) == m["total_rows"] == rows > 0


def test_distributed_eval_equals_single_device(world):
    data, ck, _ = world
    argv = ["eval", "--ckpt", ck, "--data", data, "--set", *SETS]
    ranks = run_world(argv[:1] + ["--distributed"] + argv[1:])
    assert ranks[1][1] == ""
    dist_out = json_lines(ranks[0][1])[-1]
    rc, out, _ = call(tcli.main, argv + ["--device", "cpu"])
    single = json_lines(out)[-1]
    assert rc == 0 and dist_out["eval_route_drops"] == 0
    assert (dist_out["examples"], dist_out["batches"]) == (single["examples"],
                                                           single["batches"]) == (1024, 4)
    assert abs(dist_out["auc"] - single["auc"]) <= 1e-9
    np.testing.assert_allclose(dist_out["mean_loss"], single["mean_loss"], rtol=1e-5)


def test_distributed_serve_equals_single_device(world):
    data, ck, _ = world
    argv = ["serve", "--ckpt", ck, "--data", data, "--emit", "256", "--set", "run.steps=3",
            *SETS]
    ranks = run_world(argv[:1] + ["--distributed"] + argv[1:])
    assert ranks[1][1] == "" and "serve_latency_ms" in ranks[0][2]
    rc, out, _ = call(tcli.main, argv + ["--device", "cpu"])
    got, want = json_lines(ranks[0][1]), json_lines(out)
    assert rc == 0 and len(got) == len(want) == 3
    for g, w in zip(got, want):
        # rank 0 scored the batch's even lines, rank 1 its odd ones
        p = np.asarray(w["scores"])
        np.testing.assert_allclose(g["scores"], np.concatenate([p[0::2], p[1::2]]), **TOL)
        np.testing.assert_allclose(g["mean_score"], w["mean_score"], **TOL)


def test_distributed_http_serve_equals_single_device(world):
    """`serve --distributed --http` over the 2 ranks: rank 0 alone prints
    its `serving` line; POST /score of a global batch of 37 rows (ids of
    the checkpoint, some unknown) equals the single-device
    ScoringService's within TOL, and /healthz counts the checkpoint's rows
    over 2 devices. SIGINT to rank 0 ends both ranks with 0."""
    from meepoembedding_tpu_torch.serving import ScoringService

    _, ck, _ = world
    _, table_cfg, model_cfg = tcli.load_configs(None, SETS)
    svc = ScoringService(ck, table_cfg, dataclasses.replace(model_cfg, embedding_dim=16),
                         device="cpu")
    rng = np.random.default_rng(11)
    saved = rows_by_id(ck)["ids"]
    ids = saved[rng.integers(0, len(saved), size=(37, 26))]
    ids[rng.random(ids.shape) < 0.1] = -5
    dense = rng.standard_normal((37, 13)).astype(np.float32)
    with http_world(["--ckpt", ck, "--set", *SETS]) as w:
        got = post(w["port"], "/score", {"dense": dense.tolist(), "ids": ids.tolist()})
        with urllib.request.urlopen(f"http://127.0.0.1:{w['port']}/healthz", timeout=60) as r:
            health = json.loads(r.read())
    np.testing.assert_allclose(got["scores"], svc.score(dense, ids), **TOL)
    assert health["rows"] == len(svc.table) == len(saved) and health["devices"] == S
    assert w["outs"][1][1] == "" and json_lines(w["outs"][0][1])[0]["devices"] == S


def test_http_front_ends_when_a_rank_dies(world):
    """SIGKILL to rank 1 of a `serve --distributed --http` world: rank 0's
    next request fails (an error reply) and rank 0 exits non-zero instead
    of waiting for the dead rank."""
    _, ck, _ = world
    port = free_port()
    base = world_env(S)
    argv = ["serve", "--distributed", "--http", str(port), "--ckpt", ck, "--set", *SETS]
    procs = [start_rank(argv, base, r) for r in range(S)]
    try:
        wait_healthy(port, lambda: all(p.poll() is None for p in procs),
                      lambda: [p.kill() for p in procs] and procs[0].communicate()[1][-3000:])
        procs[1].kill()
        procs[1].wait(timeout=30)
        body = {"dense": np.zeros((4, 13)).tolist(), "ids": np.ones((4, 26), np.int64).tolist()}
        with pytest.raises(urllib.error.HTTPError) as e:
            post(port, "/score", body)
        assert e.value.code == 400
        assert procs[0].wait(timeout=60) != 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def grid(world, tmp_path_factory):
    """(the 2-D checkpoint, the ranks' outputs) of a 4-step `train
    --distributed --col-shards 2` on a world of 4, and the ranks' outputs of
    a 6-step one with --spill host and LFU/TTL eviction."""
    data = world[0]
    ck = str(tmp_path_factory.mktemp("grid") / "ck")
    base = ["train", "--distributed", "--col-shards", "2", "--data", data]
    plain = run_world(base + ["--ckpt-dir", ck, "--set", "run.steps=4", "run.log_every=2",
                              *SETS], world=4)
    spill = run_world(base + ["--spill", "host", "--maintenance-every", "2", "--set",
                              "run.steps=6", "run.log_every=2", "table.policy.evict_policy=lfu_ttl",
                              "table.policy.ttl_steps=1", *SETS], world=4)
    return ck, plain, spill


def test_col_sharded_train_matches_the_single_device_trainer(world, grid, tmp_path):
    data = world[0]
    ck, outs, _ = grid
    assert all(out == "" for _, out, _ in outs[1:])
    lines = json_lines(outs[0][1])
    assert lines[-1]["steps"] == 4 and lines[-2]["route_drops"] == 0
    with open(f"{ck}/manifest.json") as f:
        m = json.load(f)
    assert (m["num_shards"], m["col_shards"], m["dim"], m["step"]) == (2, 2, 16, 4)
    run_cfg, table_cfg, model_cfg = tcli.load_configs(None, ["run.steps=4", *SETS])
    model_cfg = dataclasses.replace(model_cfg, embedding_dim=table_cfg.dim)
    tr = Trainer(run_cfg, table_cfg, model_cfg, device="cpu")
    for batch in tcli.make_train_stream(data, run_cfg, model_cfg, 0, 1).batches(4):
        tr.train_step(batch)
    single = str(tmp_path / "single")
    tr.save_checkpoint(single)
    got, want = rows_by_id(ck), rows_by_id(single)
    assert sorted(got) == sorted(want) and len(got["ids"]) == lines[-2]["rows"] > 0
    for k in want:
        if k in ("ids", "freq", "last"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)


def test_col_sharded_train_spills_from_column_zero(grid):
    _, _, outs = grid
    assert all(out == "" for _, out, _ in outs[1:])
    lines = json_lines(outs[0][1])
    last = [x for x in lines if "loss" in x][-1]
    assert lines[-1]["steps"] == 6 and last["evictions"] > 0
    assert last["spills"] == last["evictions"] and last["route_drops"] == 0


def test_col_shards_must_divide_the_world(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(SystemExit, match="must divide the world of 2"):
        tcli.main(["train", "--distributed", "--col-shards", "3", "--device", "cpu",
                   "--set", *SETS])
