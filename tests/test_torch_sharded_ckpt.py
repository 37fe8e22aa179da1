"""The multi-process checkpoint protocol of the port's ShardedTrainer, and
elastic restores between the packages: each package saves at S = 2 (the
port as 2 gloo processes, every rank writing its shard and rank 0 the
manifest), and each checkpoint restores at S = 4 into both packages (the
port's ranks building only their own shards), planes equal bit for bit.
Tolerances: `tests/_torch_dist_parity.py`."""

import os

import numpy as np
import pytest
import torch

from _torch_dist_parity import (
    DIM,
    MODEL,
    assert_params_match,
    assert_stacked_match,
    jax_trainer,
    port_counters,
    port_stacked,
    run_ranks,
    trainer_case,
)
from meepoembedding_tpu_torch import checkpoint as tckpt
from meepoembedding_tpu_torch.config import ModelConfig, OptimizerConfig, RunConfig, TableConfig
from meepoembedding_tpu_torch.train import Trainer

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """S = 2: the port's and the JAX package's trainers take the same 3
    steps and save; then a world of 4 restores both checkpoints."""
    tmp = tmp_path_factory.mktemp("ckpt")
    port_dir, jax_dir = str(tmp / "port-s2"), str(tmp / "jax-s2")
    case, ref = trainer_case(2, seed=70, evaluate=False, remove=False)
    case["args"].update(save=port_dir, extras={"note": "s2"})
    (s2,) = run_ranks(tmp, 2, [case])
    ref["trainer"].save_checkpoint(jax_dir, extras={"note": "s2"})
    run = dict(case["args"]["run"])
    args = {k: v for k, v in case["args"].items() if k not in ("save", "extras")}
    params = {k: v for k, v in case["inputs"].items() if k.startswith("p")}
    s4 = run_ranks(tmp, 4, [{"fn": "trainer", "inputs": params,
                             "args": dict(args, steps=0, restore=path)}
                            for path in (port_dir, jax_dir)])
    return {"ref": ref, "s2": s2, "s4": dict(zip(("port", "jax"), s4)), "run": run,
            "table": case["args"]["table"], "dirs": {"port": port_dir, "jax": jax_dir}}


def test_protocol_commits_one_generation(saved):
    """Both ranks wrote their shard and sidecar, rank 0 the dense leaves and
    the manifest; the manifests of the two packages agree."""
    mp, mj = (tckpt.read_manifest(saved["dirs"][k]) for k in ("port", "jax"))
    for k in ("format", "num_shards", "dim", "capacity_per_shard", "step", "value_dtype",
              "optimizer", "counts", "counters", "dense", "extras"):
        assert mp[k] == mj[k], k
    assert mp["num_shards"] == 2 and mp["dense"] == ["opt_state", "params"]
    assert sum(mp["counts"]) == int(saved["s2"][0]["rows"]) > 0
    gens = [d for d in os.listdir(saved["dirs"]["port"]) if d.startswith("step-")]
    assert gens == [mp["dir"]]
    files = sorted(os.listdir(os.path.join(saved["dirs"]["port"], mp["dir"])))
    assert [f for f in files if f.startswith("shard-")] == [
        "shard-00000.counters.npy", "shard-00000.part0000.npz",
        "shard-00001.counters.npy", "shard-00001.part0000.npz"]
    for i in range(2):  # the parts hold the same rows in the same order
        a, b = (dict(np.load(os.path.join(saved["dirs"][k], mp["dir"],
                                          f"shard-{i:05d}.part0000.npz")))
                for k in ("port", "jax"))
        for key in ("ids", "freq", "last", "n_live", "chunk_rows", "row_off"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        for key in ("values", "accum"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("source", ["port", "jax"])
def test_restore_at_four_ranks_equals_jax(saved, source):
    """A checkpoint of either package, written at S = 2, restores at S = 4
    into the port's ranks exactly as into the JAX package's mesh."""
    jt = jax_trainer(4, saved["run"], saved["table"])
    m = jt.load_checkpoint(saved["dirs"][source])
    ranks = saved["s4"][source]
    assert_stacked_match(jt.stacked, port_stacked(ranks), exact=True, what=source)
    for r in ranks:
        assert int(r["step"]) == m["step"] == 3
        assert_params_match(jt, r)
    assert port_counters(ranks[0]) == jt.counters()
    assert int(ranks[0]["rows"]) == len(jt) == sum(m["counts"])


def test_port_checkpoint_restores_on_one_device(saved):
    """The S = 2 save of the port restores into the single-device Trainer
    with every row of the two ranks' shards."""
    t = saved["table"]
    tc = TableConfig(dim=DIM, capacity=t["capacity"], optimizer=OptimizerConfig(**t["optimizer"]))
    mc = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in MODEL.items()})
    tr = Trainer(RunConfig(**saved["run"]), tc, mc, device="cpu")
    m = tr.load_checkpoint(saved["dirs"]["port"])
    got = tckpt.export_shard_arrays(tr.spec, tr.shard)
    want = list(tckpt.iter_rows(saved["dirs"]["port"]))
    ids = np.concatenate([w["ids"] for w in want])
    vals = np.concatenate([w["values"] for w in want])
    o, p = np.argsort(got["ids"]), np.argsort(ids)
    np.testing.assert_array_equal(got["ids"][o], ids[p])
    np.testing.assert_array_equal(got["values"][o], vals[p])
    assert tr.step == 3 and m["extras"] == {"note": "s2"}
