"""The port's command line (`meepoembedding_tpu_torch/cli.py`) against the JAX
package's (`meepoembedding_tpu/cli.py`): both `main`s run in-process on the
same inputs, the port's with `--device cpu`.

Exact: the subcommands and their flags (plus the port's `--device`), the
config layering, `ckpt-export` npz arrays and tsv bytes, `ckpt-inspect`
counts and manifest fields (not the generation names), `ckpt-import` rows
by id, `rows_imported` and exit code 4, the `steps` of `train`, the
examples and batches of `eval`, and the positives and recall@k of `eval
--retrieval-items` and the keys of `serve --http --retrieval-items`'s
POST /retrieve. Within rtol 1e-5 / atol 1e-6 (the
tolerances of `test_torch_serving.py` and `test_torch_train.py`: the
towers' f32 matmuls sum in another order in PyTorch than in XLA): `serve`
scores, /retrieve scores, `eval` mean loss, and the values and optimizer state of the
checkpoints `train --restore` writes; their dense params within atol 1e-4
(one Adam step moves a weight by up to the learning rate whatever its
gradient). `eval` AUCs agree within 1e-6: the logits that fill the AUC's
8192 bins agree within the tolerance above.

Checks on the port alone: the bench commands' JSON keys, one `python -m
meepoembedding_tpu_torch` subprocess, `serve --http` subprocesses answering
POST /score, and `--device cuda` raising without a card."""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import urllib.request

import numpy as np
import pytest
import torch
from _torch_cli_parity import (
    AUC_TOL,
    PARAM_TOL,
    REPO,
    SETS,
    TOL,
    both,
    call,
    data_args,
    http_server,
    reference_http_server,
    json_lines,
    post,
    rows_by_id,
    sets_for,
)

from meepoembedding_tpu import cli as jcli
from meepoembedding_tpu_torch import checkpoint as tckpt
from meepoembedding_tpu_torch import cli as tcli
from meepoembedding_tpu_torch.data.criteo import write_synthetic_criteo

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jck(tmp_path_factory):
    """A checkpoint the JAX CLI trained (4 steps), with params and Adam state."""
    path = str(tmp_path_factory.mktemp("cli") / "jck")
    rc, out, _ = call(jcli.main, ["train", "--data", "synthetic", "--ckpt-dir", path,
                                  "--set", "run.steps=4", *SETS])
    assert rc == 0 and json_lines(out)[-1]["steps"] == 4
    return path


@pytest.fixture(scope="module")
def criteo(tmp_path_factory):
    """1,024 Criteo-format lines (4 batches of 256)."""
    path = str(tmp_path_factory.mktemp("criteo") / "day.tsv")
    write_synthetic_criteo(path, 1024, seed=3)
    return path


@pytest.fixture(scope="module")
def jck_criteo(tmp_path_factory, criteo):
    """A checkpoint the JAX CLI trained (4 steps) on the Criteo lines."""
    path = str(tmp_path_factory.mktemp("cli") / "jck_criteo")
    rc, out, _ = call(jcli.main, ["train", "--data", criteo, "--ckpt-dir", path,
                                  "--set", "run.steps=4", *sets_for("criteo")])
    assert rc == 0 and json_lines(out)[-1]["steps"] == 4
    return path


# --- the front end ------------------------------------------------------------------

class _Stop(Exception):
    pass


def reference_parser(monkeypatch) -> argparse.ArgumentParser:
    """The parser the reference's `main` builds (its parse_args stopped)."""
    got = {}

    def grab(self, args=None, namespace=None):
        got["p"] = self
        raise _Stop

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Stop):
            jcli.main([])
    return got["p"]


def _subparsers(p: argparse.ArgumentParser) -> dict:
    (sub,) = [a for a in p._actions if isinstance(a, argparse._SubParsersAction)]
    return sub.choices


def _flag(a: argparse.Action) -> tuple:
    return (tuple(a.option_strings), a.dest, a.default, a.choices, a.nargs, a.required,
            a.type, type(a).__name__)


def test_subcommands_and_flags_match_the_reference(monkeypatch):
    ref, port = _subparsers(reference_parser(monkeypatch)), _subparsers(tcli.build_parser())
    assert list(port) == list(ref)
    for name, rp in ref.items():
        want = {a.dest: _flag(a) for a in rp._actions}
        got = {a.dest: _flag(a) for a in port[name]._actions}
        assert set(got) - set(want) == {"device"}, name
        for dest, f in want.items():
            assert got[dest] == f, (name, dest)
        assert got["device"][2:4] == ("cuda", ["cuda", "cpu"])


PORT_ONLY = {"interaction": "dot", "dcn_low_rank_dim": 0}


@pytest.mark.parametrize("sets", [
    [],
    ["run.steps=9", "table.capacity=1e6", "table.optimizer.kind=sgd", "model.top_mlp=64,32,1",
     "run.unique_cap=none", "run.grad_clip_norm=1.5", "table.policy.evict_policy=lfu_ttl"],
])
def test_config_layering_matches_the_reference(tmp_path, sets):
    yml = tmp_path / "c.yaml"
    yml.write_text("run: {batch_size: 512, steps: 7}\n"
                   "table: {dim: 16, optimizer: {kind: adam, learning_rate: 0.01}}\n"
                   "model: {kind: ctr_mlp, top_mlp: [32, 1]}\n")
    for path in (None, str(yml)):
        for j, t in zip(jcli.load_configs(path, sets), tcli.load_configs(path, sets)):
            got, want = dataclasses.asdict(t), dataclasses.asdict(j)
            # the port's own ModelConfig fields (config.py), at their defaults
            for k, v in PORT_ONLY.items():
                if k in got and k not in want:
                    assert got.pop(k) == v, k
            assert got == want
    for bad, err in ((["table.nope=1"], KeyError), (["bogus.x=1"], KeyError),
                     (["run.steps"], ValueError)):
        with pytest.raises(err):
            jcli.load_configs(None, bad)
        with pytest.raises(err):
            tcli.load_configs(None, bad)


# --- checkpoints -----------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["npz", "npz-full", "tsv"])
def test_ckpt_export_matches_the_reference(jck, tmp_path, fmt):
    ext = "tsv" if fmt == "tsv" else "npz"
    args = ["--format", ext] + (["--full"] if fmt == "npz-full" else [])
    (jrc, jout, _), (trc, tout, _) = both(
        ["ckpt-export", jck, "--out", str(tmp_path / f"j.{ext}"), *args],
        ["ckpt-export", jck, "--out", str(tmp_path / f"t.{ext}"), *args])
    assert jrc == trc == 0
    jm, tm = json_lines(jout)[-1], json_lines(tout)[-1]
    assert {**jm, "out": None} == {**tm, "out": None} and tm["rows"] > 0
    if ext == "tsv":
        assert (tmp_path / "t.tsv").read_bytes() == (tmp_path / "j.tsv").read_bytes()
        return
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert sorted(t.files) == sorted(j.files)
        assert ("accum" in t.files) == (fmt == "npz-full")
        for k in j.files:
            assert t[k].dtype == j[k].dtype
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_ckpt_inspect_matches_the_reference(jck):
    (jrc, jout, _), (trc, tout, _) = both(["ckpt-inspect", jck])
    assert jrc == trc == 0
    jm, tm = json.loads(jout), json.loads(tout)
    assert tm["total_rows"] == sum(tm["counts"]) > 0
    assert {**jm, "dir": None} == {**tm, "dir": None}


@pytest.mark.parametrize("case", ["npz", "tsv", "npz-overfull"])
def test_ckpt_import_matches_the_reference(tmp_path, case):
    rng = np.random.default_rng(7)
    n = 300
    ids = rng.choice(1 << 40, size=n, replace=False).astype(np.int64)
    values = rng.standard_normal((n, 8)).astype(np.float32)
    if case == "tsv":
        src = tmp_path / "dump.tsv"
        src.write_text("".join(f"{int(i)}\t" + ",".join(repr(float(x)) for x in v) + "\n"
                               for i, v in zip(ids, values)))
    else:
        src = tmp_path / "dump.npz"
        np.savez(src, ids=ids, values=values)
    # one bucket of 128 slots cannot hold 300 rows: exit code 4
    cap = ["--capacity", "128"] if case == "npz-overfull" else ["--capacity", "1024"]
    (jrc, jout, _), (trc, tout, _) = both(
        ["ckpt-import", str(src), "--out", str(tmp_path / "j"), *cap],
        ["ckpt-import", str(src), "--out", str(tmp_path / "t"), *cap])
    jm, tm = json_lines(jout)[-1], json_lines(tout)[-1]
    assert {**jm, "out": None} == {**tm, "out": None}
    assert trc == jrc == (4 if case == "npz-overfull" else 0)
    assert tm["rows_imported"] == (128 if case == "npz-overfull" else n)
    jr, tr = rows_by_id(str(tmp_path / "j")), rows_by_id(str(tmp_path / "t"))
    assert sorted(tr) == sorted(jr)
    for k in jr:
        np.testing.assert_array_equal(tr[k], jr[k], err_msg=k)
    at = np.searchsorted(ids[np.argsort(ids)], tr["ids"])
    np.testing.assert_array_equal(tr["values"], values[np.argsort(ids)][at])


# --- serve and eval ----------------------------------------------------------------

@pytest.mark.parametrize("data", ["synthetic", "bags", "criteo"])
def test_serve_matches_the_reference(jck, jck_criteo, criteo, data):
    argv = ["serve", "--ckpt", jck_criteo if data == "criteo" else jck, *data_args(data, criteo), "--emit", "256",
            "--set", "run.steps=3", *sets_for(data)]
    (jrc, jout, jerr), (trc, tout, terr) = both(argv)
    assert jrc == trc == 0
    jl, tl = json_lines(jout), json_lines(tout)
    assert [b["batch"] for b in tl] == [b["batch"] for b in jl] == [0, 1, 2]
    for j, t in zip(jl, tl):
        assert len(t["scores"]) == 256
        np.testing.assert_allclose(t["scores"], j["scores"], **TOL)
        np.testing.assert_allclose(t["mean_score"], j["mean_score"], **TOL)
    lat = json.loads(terr.strip().splitlines()[-1])
    assert lat["batches"] == 3 and set(lat["serve_latency_ms"]) == {"p50", "p95", "p99", "mean"}
    assert set(lat) == set(json.loads(jerr.strip().splitlines()[-1]))


@pytest.mark.parametrize("data", ["synthetic", "criteo"])
def test_eval_matches_the_reference(jck, jck_criteo, criteo, data):
    # Criteo: one pass over the 1,024 lines, whatever run.steps says
    argv = ["eval", "--ckpt", jck_criteo if data == "criteo" else jck, *data_args(data, criteo), "--set", "run.steps=3",
            "run.seed=5", *sets_for(data)]
    (jrc, jout, _), (trc, tout, _) = both(argv)
    assert jrc == trc == 0
    j, t = json_lines(jout)[-1], json_lines(tout)[-1]
    assert set(t) == set(j)
    assert (t["examples"], t["batches"]) == (j["examples"], j["batches"])
    assert t["examples"] == (1024 if data == "criteo" else 768)
    np.testing.assert_allclose(t["mean_loss"], j["mean_loss"], **TOL)
    assert abs(t["auc"] - j["auc"]) <= AUC_TOL


# --- train ---------------------------------------------------------------------

def test_train_restore_matches_the_reference(jck, tmp_path):
    """3 steps from the JAX checkpoint in both CLIs, then each saves."""
    (jrc, jout, _), (trc, tout, _) = both(
        ["train", "--restore", jck, "--ckpt-dir", str(tmp_path / "j"), "--set",
         "run.steps=3", *SETS],
        ["train", "--restore", jck, "--ckpt-dir", str(tmp_path / "t"), "--set",
         "run.steps=3", *SETS])
    assert jrc == trc == 0
    assert json_lines(tout)[-1]["steps"] == json_lines(jout)[-1]["steps"] == 7
    jr, tr = rows_by_id(str(tmp_path / "j")), rows_by_id(str(tmp_path / "t"))
    assert sorted(tr) == sorted(jr)
    for k in ("ids", "freq", "last"):
        np.testing.assert_array_equal(tr[k], jr[k], err_msg=k)
    for k in ("values", "accum"):
        np.testing.assert_allclose(tr[k], jr[k], **TOL, err_msg=k)
    jm, tm = tckpt.read_manifest(str(tmp_path / "j")), tckpt.read_manifest(str(tmp_path / "t"))
    assert (tm["step"], tm["counts"], tm["counters"]) == (jm["step"], jm["counts"], jm["counters"])
    for name in ("params", "opt_state"):
        jd, td = tckpt.load_dense(str(tmp_path / "j"), name), tckpt.load_dense(str(tmp_path / "t"), name)
        assert len(td) == len(jd)
        for a, b in zip(td, jd):
            np.testing.assert_allclose(a, b, **PARAM_TOL, err_msg=name)


def test_train_fresh_steps_and_logs_match_the_reference(tmp_path):
    """A fresh run: the towers start from different draws (torch.Generator
    against jax.random), so only the steps and the log's shape compare."""
    argv = ["train", "--data", "synthetic", "--set", "run.steps=4", "run.eval_every=2", *SETS]
    (jrc, jout, _), (trc, tout, _) = both(argv)
    assert jrc == trc == 0
    jl, tl = json_lines(jout), json_lines(tout)
    assert [sorted(x) for x in tl] == [sorted(x) for x in jl]
    assert tl[-1]["steps"] == jl[-1]["steps"] == 4
    assert [x["step"] for x in tl[:-1]] == [x["step"] for x in jl[:-1]]


def test_train_spill_maintenance_and_periodic_checkpoints(tmp_path):
    """--spill host with --maintenance-every spills every evicted row;
    --ckpt-every saves along the way and --ckpt-dir at the end."""
    rc, out, _ = call(tcli.main, [
        "train", "--data", "synthetic", "--device", "cpu", "--spill", "host",
        "--maintenance-every", "2", "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "3",
        "--set", "run.steps=6", "table.policy.evict_policy=lfu_ttl", "table.policy.ttl_steps=1",
        *SETS])
    assert rc == 0
    logs = json_lines(out)
    assert logs[-1]["steps"] == 6
    assert logs[-2]["ctr_evictions"] == logs[-2]["ctr_spills"] > 0
    m = tckpt.read_manifest(str(tmp_path / "ck"))
    assert m["step"] == 6 and sum(m["counts"]) == logs[-2]["ctr_inserts"] - logs[-2]["ctr_evictions"]


def test_distributed_world_of_one_and_profile_dir(tmp_path):
    """`--distributed` outside torchrun (a world of one) takes the
    single-device path, as the reference does on one device; run.profile_dir
    writes a torch.profiler trace there."""
    argv = ["train", "--data", "synthetic", "--device", "cpu", "--set", "run.steps=4", *SETS]
    runs = [call(tcli.main, argv[:1] + extra + argv[1:])
            for extra in ([], ["--distributed"])]
    drop = ("t", "examples_per_sec")
    assert [[{k: v for k, v in x.items() if k not in drop} for x in json_lines(r[1])]
            for r in runs] == [[{k: v for k, v in x.items() if k not in drop}
                                for x in json_lines(runs[0][1])]] * 2
    rc, out, _ = call(tcli.main, argv + [f"run.profile_dir={tmp_path / 'prof'}"])
    assert rc == 0 and json_lines(out)[-1]["steps"] == 4
    trace = json.loads((tmp_path / "prof" / "trace-rank0.json").read_text())
    assert trace["traceEvents"]


# --- the port alone ----------------------------------------------------------------

@pytest.mark.parametrize("cmd", ["bench-lookup", "bench-update"])
def test_bench_prints_the_reference_keys(cmd):
    rc, out, _ = call(tcli.main, [cmd, "--rows", "8192", "--batch", "1024", "--steps", "2",
                                  "--dim", "16", "--device", "cpu"])
    assert rc == 0
    line = json_lines(out)[-1]
    assert list(line) == ["metric", "value", "unit", "rows", "ms_per_step"]
    assert line["metric"] == f"{cmd.split('-')[1]}_ids_per_sec_per_chip"
    assert line["unit"] == "ids/s" and line["rows"] == 8192
    assert line["value"] > 0 and line["ms_per_step"] > 0


def test_module_entry_point_runs_in_a_subprocess(jck):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    help_ = subprocess.run([sys.executable, "-m", "meepoembedding_tpu_torch", "--help"],
                           capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert help_.returncode == 0, help_.stderr[-2000:]
    for cmd in ("train", "bench-lookup", "bench-update", "serve", "eval", "ckpt-export",
                "ckpt-import", "ckpt-inspect"):
        assert cmd in help_.stdout
    out = subprocess.run([sys.executable, "-m", "meepoembedding_tpu_torch", "ckpt-inspect", jck,
                          "--device", "cpu"],
                         capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout) == json.loads(call(tcli.main, ["ckpt-inspect", jck,
                                                                 "--device", "cpu"])[1])


@pytest.mark.parametrize("quantize", ["none", "int8", "distributed"])
def test_serve_http_answers_score(jck, quantize):
    """POST /score of a `serve --http` subprocess: f32, int8, and
    --distributed at a world of one (a ShardedScoringService, as the
    reference's), each equal to the port's service in-process."""
    from meepoembedding_tpu.serving import ScoringService as JScoringService
    from meepoembedding_tpu_torch import ScoringService

    _, table_cfg, model_cfg = tcli.load_configs(None, SETS)
    model_cfg = dataclasses.replace(model_cfg, embedding_dim=table_cfg.dim)
    q = "none" if quantize == "distributed" else quantize
    svc = ScoringService(jck, table_cfg, model_cfg, quantize=q, device="cpu")
    rng = np.random.default_rng(1)
    dense = rng.standard_normal((5, 4)).astype(np.float32)
    ids = np.concatenate([next(iter(tckpt.iter_rows(jck)))["ids"][:15],
                          rng.integers(1, 2**40, size=5)]).reshape(5, 4)
    mode = ["--distributed"] if quantize == "distributed" else ["--quantize", quantize]
    with http_server(["--ckpt", jck, *mode, "--set", *SETS]) as port:
        health = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz").read())
        assert health["ok"] and health["rows"] == len(svc.table) and health["dim"] == 16
        got = post(port, "/score", {"dense": dense.tolist(), "ids": ids.tolist()})["scores"]
    np.testing.assert_allclose(got, svc.score(dense, ids), atol=1e-6)
    if q == "none":  # and the reference's service within TOL
        _, jtable_cfg, jmodel_cfg = jcli.load_configs(None, SETS)
        jsvc = JScoringService(jck, jtable_cfg, dataclasses.replace(jmodel_cfg, embedding_dim=16))
        np.testing.assert_allclose(got, np.asarray(jsvc.score(dense, ids)), **TOL)


def test_disk_spill_defaults_to_the_temporary_directory(tmp_path, monkeypatch):
    """--spill disk without --spill-path logs to meepo_spill.log in
    tempfile.gettempdir() (TMPDIR, else /tmp)."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    rc, out, _ = call(tcli.main, [
        "train", "--data", "synthetic", "--device", "cpu", "--spill", "disk",
        "--maintenance-every", "2", "--set", "run.steps=4", "table.policy.evict_policy=lfu_ttl",
        "table.policy.ttl_steps=1", *SETS])
    assert rc == 0 and json_lines(out)[-2]["ctr_spills"] > 0
    assert (tmp_path / "meepo_spill.log").stat().st_size > 0


def test_device_cuda_raises_without_a_card(jck, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["ckpt-inspect", jck], ["eval", "--ckpt", jck, "--set", *SETS],
                 ["bench-update", "--rows", "4096", "--batch", "256"]):
        with pytest.raises(RuntimeError, match="no CUDA device is visible"):
            tcli.main(argv)


def test_eval_and_serve_retrieval_items(tmp_path, monkeypatch):
    """A two_tower the JAX CLI trained, with params: both CLIs' `eval
    --retrieval-items` count the same positives and the same recall@k, and
    both CLIs' `serve --http --retrieval-items` answer POST /retrieve with
    the same top-k keys and scores within TOL (the reference's server runs
    on a thread of this process)."""
    from meepoembedding_tpu_torch.data import SyntheticConfig, SyntheticStream

    sets = ["model.kind=two_tower", "model.num_query_features=2", "model.top_mlp=32,16",
            "run.steps=4", *SETS]
    ck = str(tmp_path / "tt")
    rc, out, _ = call(jcli.main, ["train", "--ckpt-dir", ck, "--set", *sets])
    assert rc == 0 and "params" in tckpt.read_manifest(ck)["dense"]
    batch = next(SyntheticStream(SyntheticConfig(num_dense=4, num_sparse=4, batch_size=256,
                                                 seed=0)).batches(1))
    items = np.unique(batch["ids"][:, 2:], axis=0)
    corpus = str(tmp_path / "items.npz")
    np.savez(corpus, item_ids=items, keys=np.arange(len(items)) + 100)
    (jrc, jout, _), (trc, tout, _) = both(["eval", "--ckpt", ck, "--retrieval-items", corpus,
                                           "--topk", "1,10", "--set", *sets, "run.steps=2"])
    assert jrc == trc == 0
    j, t = json_lines(jout)[-1], json_lines(tout)[-1]
    assert set(t) == set(j) == {"recall@1", "recall@10", "positives", "corpus"}
    assert (t["positives"], t["corpus"]) == (j["positives"], j["corpus"]) and t["positives"] > 0
    for k in ("recall@1", "recall@10"):
        assert t[k] == j[k], k
    q = {"dense": batch["dense"][:3].tolist(), "ids": batch["ids"][:3, :2].tolist(), "k": 5}
    serve = ["--ckpt", ck, "--retrieval-items", corpus, "--set", *sets]
    with reference_http_server(serve, monkeypatch) as port:
        want = post(port, "/retrieve", q)
    with http_server(serve) as port:
        got = post(port, "/retrieve", q)
    np.testing.assert_array_equal(got["keys"], want["keys"])
    np.testing.assert_allclose(got["scores"], want["scores"], **TOL)
