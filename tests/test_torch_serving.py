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


def test_unported_paths_raise(ckpt):
    path, _ = ckpt
    with pytest.raises(NotImplementedError):
        ScoringService(path, TableConfig(**TABLE), ModelConfig(**MODEL), quantize="int8",
                       device="cpu")
    with pytest.raises(NotImplementedError):
        build_model(ModelConfig(**{**MODEL, "kind": "dcn"}))


def test_chip_smoke_rehearses_on_cpu():
    """The card script's serve phase (checkpoint, restore, fill, requests,
    row and score checks, HTTP) at a tiny size with the plain versions. It
    must exit non-zero and print no result line: a CPU run is no chip run."""
    out = subprocess.run(
        [sys.executable, "chip_smoke.py", "--rehearse-on-cpu", "--capacity", str(1 << 14),
         "--fill-rows", "9000", "--ckpt-rows", "2000", "--part-rows", "800",
         "--requests", "2", "--batch", "16"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 1, out.stderr
    assert "serve: POST /score matches the direct score" in out.stdout
    assert '"ok": true' not in out.stdout
    assert not os.path.exists(os.path.join(REPO, "build", "chip_smoke"))


def test_port_imports_no_jax():
    code = (
        "import pkgutil, sys, importlib, meepoembedding_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'meepoembedding_tpu.'))"
        " or m == 'meepoembedding_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
