"""The port's ShardedScoringService as S = 2 and 4 gloo processes against
the JAX package's on meshes of 2 and 4 virtual CPU devices, on one
checkpoint that the JAX package's sharded trainer wrote: each rank's
scores of its rows (rtol 1e-5 / atol 1e-6), its rows of a lookup (exact),
the restored planes (exact); and at a world of one the HTTP surface and a
hot reload."""

import numpy as np
import pytest
import torch

from _torch_dist_parity import (
    MODEL,
    TOL,
    assert_stacked_match,
    batches,
    cat,
    jax_model,
    jax_table,
    port_stacked,
    run_ranks,
    trainer_case,
)
from meepoembedding_tpu.parallel.mesh import make_mesh
from meepoembedding_tpu.serving_sharded import ShardedScoringService as JShardedScoringService

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serving")
    case, ref = trainer_case(2, seed=80, evaluate=False, remove=False)
    ckpt = str(tmp / "ckpt")
    ref["trainer"].save_checkpoint(ckpt)
    table = case["args"]["table"]
    req = batches(81, 1, 64)
    trained = case["inputs"]["ids"][:3].reshape(-1)
    ids = trained[np.random.default_rng(82).integers(0, len(trained), req["ids"][0].size)]
    ids[np.random.default_rng(83).random(ids.size) < 0.1] = -12345  # unknown
    inputs = {"dense": req["dense"][0], "ids": ids.reshape(req["ids"][0].shape),
              "lookup_ids": ids[:128]}
    out = {"ckpt": ckpt, "table": table, "inputs": inputs}
    for S in (1, 2, 4):
        args = {"path": ckpt, "table": table, "model": MODEL}
        if S == 1:  # the HTTP server and a reload run at a world of one
            args.update(http=True, reload=ckpt)
        (out[S],) = run_ranks(tmp, S, [{"fn": "serve", "inputs": inputs, "args": args}])
    return out


def _jax_service(served, S):
    return JShardedScoringService(served["ckpt"], jax_table(served["table"]), jax_model(MODEL),
                                  mesh=make_mesh(S))


@pytest.mark.parametrize("S", [2, 4])
def test_sharded_scores_and_rows_match_jax(served, S):
    js = _jax_service(served, S)
    inp, ranks = served["inputs"], served[S]
    np.testing.assert_allclose(cat(ranks, "scores"), js.score(inp["dense"], inp["ids"]), **TOL)
    np.testing.assert_array_equal(cat(ranks, "rows"), js.lookup(inp["lookup_ids"]))
    assert_stacked_match(js.stacked, port_stacked(ranks), exact=True)
    for r in ranks:
        assert int(r["len"]) == len(js) and int(r["route_drops"]) == js.route_drops == 0
    assert (cat(ranks, "rows")[inp["lookup_ids"] == -12345] == 0).all()


def test_world_of_one_http_reload_and_metrics(served):
    (r,) = served[1]
    np.testing.assert_allclose(r["scores"], cat(served[2], "scores"), **TOL)
    np.testing.assert_allclose(r["http_scores"], r["scores"][:5], atol=1e-6)
    assert int(r["http_rows"]) == int(r["len"]) and int(r["http_devices"]) == 1
    assert int(r["reload_rows"]) == int(r["len"])
    text = str(r["metrics"])
    assert "meepo_mesh_devices 1" in text and "meepo_route_drops_total 0" in text
    assert f"meepo_table_rows {int(r['len'])}" in text
