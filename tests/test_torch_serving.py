"""The port's ScoringService against the JAX one on one DLRM checkpoint.

Scores agree within rtol=1e-5, atol=1e-6: the lookups are bit-exact, but the
towers' f32 matmuls sum in another order in PyTorch than in XLA. Also: the
HTTP surface, dense-param loading, and that the port never imports JAX."""

import json
import os
import subprocess
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meepoembedding_tpu import checkpoint as jckpt
from meepoembedding_tpu.config import ModelConfig as JModelConfig
from meepoembedding_tpu.config import TableConfig as JTableConfig
from meepoembedding_tpu.models.dlrm import DLRM as JDLRM
from meepoembedding_tpu.serving import ScoringService as JScoringService
from meepoembedding_tpu.table import hashing as jh
from meepoembedding_tpu.table.runtime import DynamicEmbeddingTable as JTable
from meepoembedding_tpu_torch import ScoringService, make_http_server
from meepoembedding_tpu_torch.config import ModelConfig, TableConfig
from meepoembedding_tpu_torch.models import build_model
from meepoembedding_tpu_torch.serving import pad_request, request_bucket
from meepoembedding_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLE = dict(dim=8, capacity=4096)
MODEL = dict(kind="dlrm", num_dense_features=4, num_sparse_features=3, embedding_dim=8,
             bottom_mlp=(16, 8), top_mlp=(16, 1))


def _params(seed=1):
    """JAX DLRM params with nonzero biases (init leaves them zero)."""
    params = JDLRM(JModelConfig(**MODEL)).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: x + jnp.asarray(rng.normal(size=x.shape, scale=0.1), x.dtype), params
    )


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("srv") / "ck")
    t = JTable(JTableConfig(**TABLE))
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 2**40, size=2000, dtype=np.int64)
    t.assign(ids, rng.normal(size=(2000, 8)).astype(np.float32))
    t.step = 11
    jckpt.save(path, t.spec, [t.shard], t.step, dense={"params": _params()})
    return path, ids


def _requests(ids, rng, b):
    known = rng.choice(ids, size=(b, 3))
    unknown = rng.integers(2**41, 2**42, size=(b, 3))
    onehot = np.where(rng.random((b, 3)) < 0.8, known, unknown)
    bags = np.where(rng.random((b, 3, 4)) < 0.7, rng.choice(ids, size=(b, 3, 4)),
                    rng.integers(2**41, 2**42, size=(b, 3, 4)))
    bags[rng.random((b, 3, 4)) < 0.3] = jh.EMPTY_ID  # bag padding
    bags[0, 0] = jh.EMPTY_ID  # one empty bag
    return rng.normal(size=(b, 4)).astype(np.float32), onehot, bags


@pytest.mark.parametrize("combiner", ["mean", "sum", "sqrtn"])
def test_scores_match_jax(ckpt, combiner):
    path, ids = ckpt
    jsvc = JScoringService(path, JTableConfig(**TABLE), JModelConfig(**MODEL, combiner=combiner))
    tsvc = ScoringService(path, TableConfig(**TABLE), ModelConfig(**MODEL, combiner=combiner),
                          device="cpu")
    assert tsvc.stats() == jsvc.stats()
    rng = np.random.default_rng(5)
    for b in (8, 5):  # power of two and not
        dense, onehot, bags = _requests(ids, rng, b)
        for x in (onehot, bags):
            want = np.asarray(jsvc.score(dense, x))
            got = tsvc.score(dense, x)
            assert got.shape == (b,) and got.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_request_bucket_and_padding():
    assert [request_bucket(c) for c in (1, 2, 3, 128, 129, 700, 2048)] == [
        1, 2, 4, 128, 256, 1024, 2048]
    rng = np.random.default_rng(2)
    dense = rng.normal(size=(5, 4)).astype(np.float32)
    ids = rng.integers(0, 2**40, size=(5, 3))
    dense_out = np.full((8, 4), np.nan, np.float32)
    ids_out = np.full((8, 3), 7, np.int64)
    pad_request(dense, ids, dense_out, ids_out)
    np.testing.assert_array_equal(dense_out, np.concatenate([dense, np.zeros((3, 4))]))
    np.testing.assert_array_equal(ids_out[:5], ids)
    assert (ids_out[5:] == jh.EMPTY_ID).all()


def test_cpu_service_never_takes_the_graph_path(ckpt):
    """On the CPU every request is eager: no graph captured or replayed, and
    the scores are the tower's over the probe-only rows."""
    path, ids = ckpt
    svc = ScoringService(path, TableConfig(**TABLE), ModelConfig(**MODEL), device="cpu")
    rng = np.random.default_rng(4)
    for b in (4, 5, 4):
        dense, onehot, bags = _requests(ids, rng, b)
        got = svc.score(dense, onehot)
        with torch.no_grad():
            rows = svc.table.lookup(onehot.reshape(-1), train=False).view(b, 3, 8)
            want = torch.sigmoid(svc.model(torch.from_numpy(dense), rows)).numpy()
        np.testing.assert_array_equal(got, want)
        svc.score(dense, bags)
    assert (svc.graph_replays, svc.graph_captures, svc.eager_requests) == (0, 0, 6)
    text = svc.metrics_text()
    for line in ("meepo_graph_replays_total 0", "meepo_graph_captures_total 0",
                 "meepo_eager_requests_total 6", "meepo_requests_total 6"):
        assert line in text


def test_only_a_request_at_the_towers_widths_takes_the_graph_path(ckpt, monkeypatch):
    """A one-hot request of another number of sparse or dense features than
    the tower's goes the eager way (and fails there), so that it never
    allocates, captures or caches a graph. The test reads shapes and the
    device only, so a CPU service that says it is on a card stands in."""
    path, ids = ckpt
    svc = ScoringService(path, TableConfig(**TABLE), ModelConfig(**MODEL), device="cpu")
    monkeypatch.setattr(svc, "device", torch.device("cuda"))
    dense, onehot, bags = _requests(ids, np.random.default_rng(6), 5)
    assert svc._takes_graph(dense, onehot)
    for d, i in ((dense, bags), (dense, onehot[:, :2]), (dense[:, :3], onehot),
                 (dense, np.concatenate([onehot, onehot], 1)), (dense[:4], onehot)):
        assert not svc._takes_graph(d, i), (d.shape, i.shape)


def test_from_jax_params_nested_and_flat():
    params = _params(3)
    nested = from_jax_params(build_model(ModelConfig(**MODEL)), params)
    flat = from_jax_params(build_model(ModelConfig(**MODEL)),
                           [np.asarray(x) for x in jax.tree_util.tree_leaves(params)])
    for a, b in zip(nested.state_dict().values(), flat.state_dict().values()):
        assert torch.equal(a, b)
    rng = np.random.default_rng(0)
    dense = rng.normal(size=(6, 4)).astype(np.float32)
    emb = rng.normal(size=(6, 3, 8)).astype(np.float32)
    want = JDLRM(JModelConfig(**MODEL)).apply(params, jnp.asarray(dense), jnp.asarray(emb))
    with torch.no_grad():
        got = nested(torch.from_numpy(dense), torch.from_numpy(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        from_jax_params(build_model(ModelConfig(**{**MODEL, "top_mlp": (8, 1)})), params)


def test_http_round_trip(ckpt):
    path, ids = ckpt
    svc = ScoringService(path, TableConfig(**TABLE), ModelConfig(**MODEL), device="cpu")
    server = make_http_server(svc, 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        dense, onehot, _ = _requests(ids, np.random.default_rng(9), 5)
        req = json.dumps({"dense": dense.tolist(), "ids": onehot.tolist()}).encode()
        with urllib.request.urlopen(urllib.request.Request(base + "/score", data=req)) as r:
            scores = np.asarray(json.loads(r.read())["scores"])
        np.testing.assert_allclose(scores, svc.score(dense, onehot), atol=1e-6)
        with urllib.request.urlopen(base + "/healthz") as r:
            assert json.loads(r.read()) == {"ok": True, "rows": 2000, "step": 11, "dim": 8}
        with urllib.request.urlopen(base + "/metrics") as r:
            text = r.read().decode()
        assert "meepo_requests_total 2" in text and "meepo_table_rows 2000" in text
        reload_req = urllib.request.Request(base + "/reload", data=b"{}")
        with urllib.request.urlopen(reload_req) as r:
            assert json.loads(r.read())["rows"] == 2000
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_unported_paths_raise(ckpt, tmp_path):
    """What is refused raises: a quantizer other than int8, an unknown
    model kind. The row-sharded group service, once refused here, scores on
    a world of one what the single-device service scores."""
    from meepoembedding_tpu_torch.config import RunConfig
    from meepoembedding_tpu_torch.group_train import GroupTrainer
    from meepoembedding_tpu_torch.parallel import mesh as pmesh
    from meepoembedding_tpu_torch.serving_group import GroupScoringService

    path, _ = ckpt
    args = (RunConfig(batch_size=32), {"t": TableConfig(**TABLE)}, ["t"] * 3,
            ModelConfig(**MODEL))
    rng = np.random.default_rng(3)
    dense = rng.standard_normal((32, 4)).astype(np.float32)
    ids = rng.integers(0, 500, (32, 3)).astype(np.int64)
    gt = GroupTrainer(*args, device="cpu")
    gt.train_step({"dense": dense, "ids": ids, "label": np.ones(32, np.float32)})
    gt.save_checkpoint(str(tmp_path / "g"))
    joined = not torch.distributed.is_initialized()
    try:
        want = GroupScoringService(str(tmp_path / "g"), *args, device="cpu").score(dense, ids)
        got = GroupScoringService(str(tmp_path / "g"), *args, distributed=True,
                                  device="cpu").score(dense, ids)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    finally:
        if joined:
            pmesh.destroy()
    with pytest.raises(ValueError, match=r"none\|int8"):
        ScoringService(path, TableConfig(**TABLE), ModelConfig(**MODEL), quantize="int4",
                       device="cpu")
    with pytest.raises(ValueError, match="unknown model kind"):
        build_model(ModelConfig(**{**MODEL, "kind": "wide_and_deep"}))


def test_chip_smoke_rehearses_on_cpu():
    """The card script's serve phase (checkpoint, restore, fill, requests,
    row and score checks, HTTP), int8, sharded (a gloo world of one),
    colsharded (two rank processes), train and lifecycle phases (eviction
    into a spill tier, remove, promotion, checkpoints, growth), the zoo,
    embed, retrieval, group and group_sharded phases, the cli phase (train
    through `python -m`, export and import, card vs CPU, the bench
    commands, serve and eval of the serve checkpoint), the sharded_http
    phase (one HTTP front over two rank processes), the entry phase and
    the harness phase (every `bench/` harness, and the headline's `python
    -m`) and the dma phase (K6 and K7 against their plain versions at every
    point of bench_dma.py's sweeps, the DMA probe and its two sibling
    harnesses) at a tiny size with the plain versions. It must exit non-zero and print no
    result line: a CPU run is no chip run."""
    out = subprocess.run(
        [sys.executable, "chip_smoke.py", "--rehearse-on-cpu", "--capacity", str(1 << 14),
         "--fill-rows", "9000", "--ckpt-rows", "2000", "--part-rows", "800",
         "--requests", "2", "--batch", "16"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 1, out.stderr
    assert "serve: POST /score matches the direct score" in out.stdout
    assert "train: step p50" in out.stdout and "drops 0" in out.stdout
    assert "each pass's spilled rows equal the window's planes" in out.stdout
    assert "rows equal their spilled payload bit for bit" in out.stdout
    assert "every earlier row's planes kept bit for bit" in out.stdout
    assert "zoo din: a checkpoint restored into a ScoringService" in out.stdout
    assert "int8: POST /score matches the direct score" in out.stdout
    assert "check embed parity: 3 steps" in out.stdout and "embed live: inserts" in out.stdout
    assert "retrieval: POST /retrieve matches retrieve" in out.stdout
    assert "equal the trainer's eval_step probabilities" in out.stdout
    assert "check sharded parity (ragged exchange" in out.stdout
    assert "sharded: the exchange's tax at S = 1" in out.stdout
    assert "sharded serve: POST /score matches the direct score" in out.stdout
    assert "restored into a ShardedTrainer and a Trainer" in out.stdout
    assert "cli: python -m meepoembedding_tpu_torch train: 1 + 2 steps" in out.stdout
    assert "imported rows equal the export bit for bit" in out.stdout
    assert "cli: eval and serve, cpu against the CPU" in out.stdout
    assert '"metric": "update_ids_per_sec_per_chip"' in out.stdout
    assert "equal to the service's scores' AUC and loss" in out.stdout
    assert "colsharded small copy: 3 steps" in out.stdout
    assert "accumulator bit-identical across the columns" in out.stdout
    assert "their full rows and accumulators equal the payloads bit for bit" in out.stdout
    assert "check group_sharded parity (ragged exchange" in out.stdout
    assert "harness ckpt_full: " in out.stdout and '"sample_bit_exact": true' in out.stdout
    assert "harness: python -m meepoembedding_tpu_torch.bench.headline" in out.stdout
    assert "calls held against the plain versions on the same inputs" in out.stdout
    assert "GroupScoringService(distributed=True) scores 32 requests" in out.stdout
    assert "the stop op ended both ranks with 0" in out.stdout
    assert "/retrieve over 4096 items equals the single-device keys" in out.stdout
    assert "entry: forward of 256 x 8 ids" in out.stdout and "dryrun_multichip(1) passed" in out.stdout
    assert "check row_block_scatter R=16, W in [32, 256] (run at [28, 28])" in out.stdout
    assert "a ring that does not fit is refused" in out.stdout
    for name in ("dma", "row_kernels", "dedup_variants"):
        assert f"dma {name}: {{" in out.stdout, name
    # bench.dma's 23 distinct (R, W run) of its 30 points and its row_gather, each held once
    assert "dma dma: 24 calls held against the plain versions" in out.stdout
    assert "row_block_scatter R=16 W=28" in out.stdout
    assert "dma row_kernels: 3 calls held against the plain versions" in out.stdout
    assert "rehearsal finished" in out.stdout
    assert '"ok": true' not in out.stdout
    assert not os.path.exists(os.path.join(REPO, "build", "chip_smoke"))
    assert not os.path.exists(os.path.join(REPO, "build", "chip_smoke_cli"))
    assert not os.path.exists(os.path.join(REPO, "build", "chip_smoke_http"))


def test_port_imports_no_jax():
    code = (
        "import pkgutil, sys, importlib, meepoembedding_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'meepoembedding_tpu.'))"
        " or m == 'meepoembedding_tpu']\n"
        "assert not bad, bad\n"
        "assert 'meepoembedding_tpu_torch.entry' in sys.modules\n"
        "assert 'meepoembedding_tpu_torch.bench.headline' in sys.modules\n"
        "assert 'meepoembedding_tpu_torch.bench.dma' in sys.modules\n"
        "assert 'meepoembedding_tpu_torch.table.oracle' in sys.modules\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
