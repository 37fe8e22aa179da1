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
  those lines."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from _torch_cli_parity import REPO, TOL, call, free_port, json_lines

from meepoembedding_tpu_torch import cli as tcli
from meepoembedding_tpu_torch.data.criteo import write_synthetic_criteo

torch.set_num_threads(1)

S = 2
# Criteo's 13 dense and 26 sparse columns, dim 16, 2^16 slots over the ranks
SETS = ["run.batch_size=256", "table.capacity=65536", "table.dim=16",
        "model.num_sparse_features=26", "model.num_dense_features=13",
        "model.bottom_mlp=32,16", "model.top_mlp=32,1"]


def run_world(argv: list, timeout: float = 120.0) -> list:
    """(exit code, stdout, stderr) of each rank of a world of S running
    `python -m meepoembedding_tpu_torch <argv> --device cpu`."""
    base = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(free_port()), WORLD_SIZE=str(S))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "meepoembedding_tpu_torch", *argv, "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=dict(base, RANK=str(r), LOCAL_RANK=str(r))) for r in range(S)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        errs = [p.communicate()[1][-3000:] for p in procs]
        raise AssertionError("world timed out:\n" + "\n".join(
            f"rank {r} of {S}:\n{e}" for r, e in enumerate(errs)))
    for r, (rc, _, err) in enumerate(outs):
        assert rc == 0, f"rank {r} of {S} failed:\n{err[-3000:]}"
    return outs


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
