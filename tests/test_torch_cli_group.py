"""The port's command line on a `tables:` group config against the JAX
package's, on one device: `train` (fresh and `--restore`), batch `serve`,
`eval` and `ckpt-inspect` of a group checkpoint the JAX CLI trained, both
`main`s in-process on the same inputs (the port's with `--device cpu`);
and the port's `serve --http` of that checkpoint in a subprocess.

With --distributed over a world of 2 gloo ranks (`run_world`), on a
Criteo-shaped group whose ranks read lines i % 2 == rank: `train` writes
the rows the port's single-device GroupTrainer trains on the same global
batches (a fresh sharded run cannot match the reference's, whose one
process reads whole batches); `eval`, `serve` and `serve --http` of the
JAX-written group checkpoint give the single-device port's results, which
the tests above hold against the reference's.

Exact: the steps, the members' ids, freq and last, their counts and
counters, the inspected manifests (not the generation names), eval's
examples and batches. Within rtol 1e-5 / atol 1e-6 (`test_torch_group.py`'s
tolerances): scores, eval's mean loss, the members' values and optimizer
state; dense params within atol 1e-4 (an Adam step moves a weight by up to
the learning rate); eval AUCs within 1e-6."""

import json
import os

import numpy as np
import pytest
import torch
from _torch_cli_parity import (
    AUC_TOL,
    PARAM_TOL,
    TOL,
    both,
    call,
    http_server,
    http_world,
    json_lines,
    post,
    rows_by_id,
    run_world,
)

from meepoembedding_tpu import cli as jcli
from meepoembedding_tpu_torch import checkpoint as tckpt
from meepoembedding_tpu_torch import cli as tcli
from meepoembedding_tpu_torch.data.criteo import write_synthetic_criteo
from meepoembedding_tpu_torch.group_train import GroupTrainer
from meepoembedding_tpu_torch.serving_group import GroupScoringService

torch.set_num_threads(1)

GROUP_YAML = """
tables:
  user: {dim: 16, capacity: 4096}
  item: {dim: 8, capacity: 2048, optimizer: {kind: ftrl, learning_rate: 0.05}}
feature_map: [user, item, item, user]
run: {steps: 4, batch_size: 256, log_every: 2}
model: {num_dense_features: 4, top_mlp: [32, 1]}
"""
MEMBERS = ("item", "user")


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """(the YAML, a group checkpoint the JAX CLI trained for 4 steps)."""
    d = tmp_path_factory.mktemp("group")
    (d / "group.yaml").write_text(GROUP_YAML)
    cfg, ck = str(d / "group.yaml"), str(d / "gck")
    rc, out, _ = call(jcli.main, ["train", "--config", cfg, "--data", "synthetic",
                                  "--ckpt-dir", ck])
    assert rc == 0 and json_lines(out)[-1]["steps"] == 4
    return cfg, ck


def test_group_serve_matches_the_reference(group):
    cfg, ck = group
    (jrc, jout, jerr), (trc, tout, terr) = both(
        ["serve", "--config", cfg, "--ckpt", ck, "--emit", "256", "--set", "run.steps=3"])
    assert jrc == trc == 0
    jl, tl = json_lines(jout), json_lines(tout)
    assert len(tl) == len(jl) == 3
    for j, t in zip(jl, tl):
        assert t["batch"] == j["batch"] and len(t["scores"]) == 256
        np.testing.assert_allclose(t["scores"], j["scores"], **TOL)
        np.testing.assert_allclose(t["mean_score"], j["mean_score"], **TOL)
    assert json.loads(terr.strip().splitlines()[-1])["batches"] == 3


def test_group_eval_matches_the_reference(group):
    cfg, ck = group
    (jrc, jout, _), (trc, tout, _) = both(
        ["eval", "--config", cfg, "--ckpt", ck, "--set", "run.steps=3", "run.seed=5"])
    assert jrc == trc == 0
    j, t = json_lines(jout)[-1], json_lines(tout)[-1]
    assert set(t) == set(j) and (t["examples"], t["batches"]) == (j["examples"], j["batches"])
    np.testing.assert_allclose(t["mean_loss"], j["mean_loss"], **TOL)
    assert abs(t["auc"] - j["auc"]) <= AUC_TOL


def test_group_ckpt_inspect_matches_the_reference(group):
    _, ck = group
    (jrc, jout, _), (trc, tout, _) = both(["ckpt-inspect", ck])
    assert jrc == trc == 0
    jm, tm = json.loads(jout), json.loads(tout)
    for m in (jm, tm):
        for t in m["tables"].values():
            t["dir"] = None
    assert tm == jm and tm["total_rows"] > 0


def test_group_train_restore_matches_the_reference(group, tmp_path):
    cfg, ck = group
    (jrc, jout, _), (trc, tout, _) = both(
        ["train", "--config", cfg, "--restore", ck, "--ckpt-dir", str(tmp_path / "j"),
         "--set", "run.steps=3"],
        ["train", "--config", cfg, "--restore", ck, "--ckpt-dir", str(tmp_path / "t"),
         "--set", "run.steps=3"])
    assert jrc == trc == 0
    assert json_lines(tout)[-1]["steps"] == json_lines(jout)[-1]["steps"] == 7
    with open(tmp_path / "j" / "group.json") as f, open(tmp_path / "t" / "group.json") as g:
        assert json.load(g) == json.load(f)
    for name in MEMBERS:
        jp, tp = str(tmp_path / "j" / f"table-{name}"), str(tmp_path / "t" / f"table-{name}")
        jr, tr = rows_by_id(jp), rows_by_id(tp)
        assert sorted(tr) == sorted(jr)
        for k in tr:
            if k in ("ids", "freq", "last"):
                np.testing.assert_array_equal(tr[k], jr[k], err_msg=f"{name} {k}")
            else:
                np.testing.assert_allclose(tr[k], jr[k], **TOL, err_msg=f"{name} {k}")
        jm, tm = tckpt.read_manifest(jp), tckpt.read_manifest(tp)
        assert (tm["step"], tm["counts"], tm["counters"]) == (jm["step"], jm["counts"],
                                                               jm["counters"])
    first = str(tmp_path / "{}" / f"table-{MEMBERS[0]}")
    for name in ("params", "opt_state"):
        jd, td = tckpt.load_dense(first.format("j"), name), tckpt.load_dense(first.format("t"), name)
        assert len(td) == len(jd)
        for a, b in zip(td, jd):
            np.testing.assert_allclose(a, b, **PARAM_TOL, err_msg=name)


def test_group_fresh_train_logs_match_the_reference(group):
    """A fresh run (the heads start from different draws): steps, the log's
    keys and the members listed under `rows`."""
    cfg, _ = group
    (jrc, jout, _), (trc, tout, _) = both(["train", "--config", cfg, "--data", "synthetic"])
    assert jrc == trc == 0
    jl, tl = json_lines(jout), json_lines(tout)
    assert [sorted(x) for x in tl] == [sorted(x) for x in jl]
    assert tl[-1]["steps"] == jl[-1]["steps"] == 4
    assert set(tl[-2]["rows"]) == set(MEMBERS)
    assert tl[-2]["rows"] == jl[-2]["rows"]  # the same ids inserted, whatever the head


def test_group_serve_http_answers_score(group):
    cfg, ck = group
    run_cfg, tables, fmap, model_cfg = tcli.load_group_configs(cfg)
    svc = GroupScoringService(ck, run_cfg, tables, fmap, model_cfg, device="cpu")
    rng = np.random.default_rng(2)
    dense = rng.standard_normal((3, 4)).astype(np.float32)
    ids = rng.integers(0, 400, size=(3, 4))
    with http_server(["--config", cfg, "--ckpt", ck]) as port:
        got = post(port, "/score", {"dense": dense.tolist(), "ids": ids.tolist()})["scores"]
    np.testing.assert_allclose(got, svc.score(dense, ids), atol=1e-6)
    assert os.path.exists(os.path.join(ck, "group.json"))


CRITEO_GROUP_YAML = """
tables:
  user: {dim: 16, capacity: 16384}
  item: {dim: 8, capacity: 16384, optimizer: {kind: ftrl, learning_rate: 0.05}}
feature_map: [%s]
run: {steps: 4, batch_size: 256, log_every: 2}
model: {num_dense_features: 13, top_mlp: [32, 1]}
""" % ", ".join(["user"] * 13 + ["item"] * 13)


@pytest.fixture(scope="module")
def criteo_group(tmp_path_factory):
    """(the YAML, 1,024 Criteo lines, a group checkpoint the JAX CLI trained
    on them for 4 steps)."""
    d = tmp_path_factory.mktemp("criteo_group")
    (d / "group.yaml").write_text(CRITEO_GROUP_YAML)
    cfg, data, ck = str(d / "group.yaml"), str(d / "day.tsv"), str(d / "gck")
    write_synthetic_criteo(data, 1024, seed=6)
    rc, out, _ = call(jcli.main, ["train", "--config", cfg, "--data", data, "--ckpt-dir", ck])
    assert rc == 0 and json_lines(out)[-1]["steps"] == 4
    return cfg, data, ck


def test_group_distributed_train_matches_the_single_device_trainer(criteo_group, tmp_path):
    cfg, data, _ = criteo_group
    ck = str(tmp_path / "dist")
    outs = run_world(["train", "--distributed", "--config", cfg, "--data", data,
                      "--ckpt-dir", ck])
    assert outs[1][1] == ""
    lines = json_lines(outs[0][1])
    assert lines[-1]["steps"] == 4 and [x["step"] for x in lines[:-1]] == [2, 4]
    with open(f"{ck}/group.json") as f:
        assert json.load(f)["num_shards"] == 2
    run_cfg, tables, fmap, model_cfg = tcli.load_group_configs(cfg)
    tr = GroupTrainer(run_cfg, tables, fmap, model_cfg, device="cpu")
    for batch in tcli.make_train_stream(data, run_cfg, model_cfg, 0, 1).batches(4):
        tr.train_step(batch)
    tr.save_checkpoint(str(tmp_path / "single"))
    for name in MEMBERS:
        got = rows_by_id(f"{ck}/table-{name}")
        want = rows_by_id(str(tmp_path / "single" / f"table-{name}"))
        assert sorted(got) == sorted(want)
        assert len(got["ids"]) == lines[-2]["rows"][name] > 0
        for k in want:
            if k in ("ids", "freq", "last"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} {k}")
            else:
                np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=f"{name} {k}")


def test_group_distributed_eval_equals_single_device(criteo_group):
    cfg, data, ck = criteo_group
    argv = ["eval", "--config", cfg, "--ckpt", ck, "--data", data]
    ranks = run_world(argv[:1] + ["--distributed"] + argv[1:])
    assert ranks[1][1] == ""
    got = json_lines(ranks[0][1])[-1]
    rc, out, _ = call(tcli.main, argv + ["--device", "cpu"])
    want = json_lines(out)[-1]
    assert rc == 0 and got["eval_route_drops"] == 0
    assert (got["examples"], got["batches"]) == (want["examples"], want["batches"]) == (1024, 4)
    assert abs(got["auc"] - want["auc"]) <= 1e-9
    np.testing.assert_allclose(got["mean_loss"], want["mean_loss"], rtol=1e-5)


def test_group_distributed_serve_equals_single_device(criteo_group):
    cfg, data, ck = criteo_group
    argv = ["serve", "--config", cfg, "--ckpt", ck, "--data", data, "--emit", "256",
            "--set", "run.steps=3"]
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


def test_group_distributed_http_serve_equals_single_device(criteo_group):
    """`serve --distributed --http` of the group checkpoint over 2 ranks:
    POST /score of a global batch of 37 rows equals the single-device
    GroupScoringService's within TOL; /healthz counts its members' rows;
    SIGINT to rank 0 ends both ranks with 0, rank 1 having printed
    nothing."""
    cfg, _, ck = criteo_group
    run_cfg, tables, fmap, model_cfg = tcli.load_group_configs(cfg)
    svc = GroupScoringService(ck, run_cfg, tables, fmap, model_cfg, device="cpu")
    rng = np.random.default_rng(12)
    dense = rng.standard_normal((37, 13)).astype(np.float32)
    ids = rng.integers(0, 400, size=(37, 26))
    with http_world(["--config", cfg, "--ckpt", ck]) as w:
        got = post(w["port"], "/score", {"dense": dense.tolist(), "ids": ids.tolist()})
        health = post(w["port"], "/reload", {})
    np.testing.assert_allclose(got["scores"], svc.score(dense, ids), **TOL)
    assert health["rows"] == svc.stats()["rows"] > 0 and health["devices"] == 2
    assert w["outs"][1][1] == "" and json_lines(w["outs"][0][1])[0]["devices"] == 2
