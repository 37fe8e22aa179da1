"""The port's `ItemIndex` and `RetrievalService` (and POST /retrieve)
against the JAX package's, on the same vectors and on one JAX-trained
two-tower checkpoint.

Exact: the keys returned (the inputs have no near ties) and recall@k.
Within atol 1e-5: scores (f32 products summed in another order; the index
in bf16 is rounded alike in both packages)."""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from meepoembedding_tpu.config import ModelConfig as JModelConfig
from meepoembedding_tpu.config import OptimizerConfig as JOptimizerConfig
from meepoembedding_tpu.config import RunConfig as JRunConfig
from meepoembedding_tpu.config import TableConfig as JTableConfig
from meepoembedding_tpu.retrieval import ItemIndex as JItemIndex
from meepoembedding_tpu.retrieval import RetrievalService as JRetrievalService
from meepoembedding_tpu.serving import ScoringService as JScoringService
from meepoembedding_tpu.train import Trainer as JTrainer
from meepoembedding_tpu_torch import ScoringService, make_http_server
from meepoembedding_tpu_torch.config import ModelConfig, OptimizerConfig, TableConfig
from meepoembedding_tpu_torch.retrieval import ItemIndex, RetrievalService

torch.set_num_threads(1)

# the item ids' offset; below 2^31, where the JAX QuantizedTable keeps ids
# apart (it holds them in int32, ROADMAP "Differences kept on purpose")
ITEM_NS = np.int64(1) << 20
VOCAB = 32
MODEL = dict(kind="two_tower", num_dense_features=2, num_sparse_features=2,
             num_query_features=1, embedding_dim=16, bottom_mlp=(32, 16), top_mlp=(8, 1))
TABLE = dict(dim=16, capacity=1 << 12)
OPT = dict(kind="rowwise_adagrad", learning_rate=0.1)


def pair_batch(rng, batch=64):
    """Query id q pairs with item id q, all positives."""
    q = rng.integers(0, VOCAB, size=batch)
    return {"ids": np.stack([q, ITEM_NS | q], axis=1).astype(np.int64),
            "dense": rng.normal(size=(batch, 2)).astype(np.float32) * 0.1,
            "label": np.ones(batch, np.float32)}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A two-tower trained by the JAX package on the planted pairs."""
    tr = JTrainer(JRunConfig(batch_size=64, steps=150, dense_learning_rate=3e-3),
                  JTableConfig(**TABLE, optimizer=JOptimizerConfig(**OPT)),
                  JModelConfig(**MODEL))
    rng = np.random.default_rng(0)
    for _ in range(150):
        tr.train_step(pair_batch(rng))
    path = str(tmp_path_factory.mktemp("tt") / "ck")
    tr.save_checkpoint(path)
    return path


def services(path, quantize):
    jsvc = JScoringService(path, JTableConfig(**TABLE, optimizer=JOptimizerConfig(**OPT)),
                           JModelConfig(**MODEL), quantize=quantize)
    tsvc = ScoringService(path, TableConfig(**TABLE, optimizer=OptimizerConfig(**OPT)),
                          ModelConfig(**MODEL), quantize=quantize, device="cpu")
    return JRetrievalService(jsvc), RetrievalService(tsvc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_item_index_matches_jax(dtype):
    rng = np.random.default_rng(1)
    v = rng.normal(size=(1000, 24)).astype(np.float32)
    q = rng.normal(size=(7, 24)).astype(np.float32)
    keys = np.arange(1000, dtype=np.int64) * 7 + 3
    got_k, got_s = ItemIndex(v, keys=keys, chunk=128, dtype=dtype, device="cpu").topk(q, 5)
    want_k, want_s = JItemIndex(v, keys=keys, chunk=128, dtype=dtype).topk(q, 5)  # 8 chunks
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-5)
    vq = torch.from_numpy(v).to(getattr(torch, dtype)).float().numpy()
    ref = q @ vq.T
    top = np.argsort(-ref, axis=1)[:, :5]
    np.testing.assert_array_equal(got_k, keys[top])
    np.testing.assert_allclose(got_s, np.take_along_axis(ref, top, 1), rtol=0, atol=1e-5)


def test_item_index_k_exceeding_corpus():
    rng = np.random.default_rng(2)
    v = rng.normal(size=(5, 8)).astype(np.float32)
    q = rng.normal(size=(2, 8)).astype(np.float32)
    keys, scores = ItemIndex(v, device="cpu").topk(q, 64)
    jkeys, jscores = JItemIndex(v).topk(q, 64)
    assert keys.shape == (2, 5)  # clamped to the corpus; the padding never leaks
    np.testing.assert_array_equal(keys, jkeys)
    np.testing.assert_allclose(scores, jscores, rtol=0, atol=1e-5)
    assert np.isfinite(scores).all() and set(keys[0]) == set(range(5))


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_retrieve_and_evaluate_match_jax(ckpt, quantize):
    jret, tret = services(ckpt, quantize)
    item_ids = (ITEM_NS | np.arange(VOCAB, dtype=np.int64))[:, None]
    keys = np.arange(VOCAB, dtype=np.int64) * 3
    tret.build_index(item_ids, keys=keys)
    jret.build_index(item_ids, keys=keys)
    assert tret.index.num_items == VOCAB
    qids = np.arange(VOCAB, dtype=np.int64)[:, None]
    dense = np.random.default_rng(3).normal(size=(VOCAB, 2)).astype(np.float32) * 0.1
    got_k, got_s = tret.retrieve(dense, qids, k=4)
    want_k, want_s = jret.retrieve(dense, qids, k=4)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-5)
    assert (got_k[:, 0] == keys).mean() >= 0.9  # the planted pairs are learnt
    rng = np.random.default_rng(11)
    batches = [pair_batch(rng) for _ in range(3)]
    out = tret.evaluate(batches, ks=(1, 32))
    assert out == jret.evaluate(batches, ks=(1, 32))
    assert out["positives"] == 192 and out["recall@32"] == 1.0
    # a corpus missing half the items: its recall is bounded by its coverage
    tret.build_index(item_ids[:16], keys=keys[:16])
    jret.build_index(item_ids[:16], keys=keys[:16])
    assert tret.evaluate(batches, ks=(32,)) == jret.evaluate(batches, ks=(32,))


def test_retrieve_over_http(ckpt):
    _, tret = services(ckpt, "none")
    item_ids = (ITEM_NS | np.arange(VOCAB, dtype=np.int64))[:, None]
    tret.build_index(item_ids)
    plain = make_http_server(tret.scoring, 0)
    srv = make_http_server(tret.scoring, 0, retrieval=tret)
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in (srv, plain)]
    for t in threads:
        t.start()

    def post(server, body):
        url = f"http://127.0.0.1:{server.server_address[1]}/retrieve"
        req = urllib.request.Request(url, data=json.dumps(body).encode())
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        dense, qids = [[0.0, 0.1], [0.2, 0.0]], [[4], [9]]
        code, r = post(srv, {"dense": dense, "ids": qids, "k": 3})
        keys, scores = tret.retrieve(np.asarray(dense, np.float32), np.asarray(qids), k=3)
        assert code == 200 and r["keys"] == keys.tolist()
        np.testing.assert_allclose(r["scores"], scores, atol=1e-6)
        assert post(srv, {"dense": dense, "ids": [[4]]})[0] == 400  # length mismatch
        assert post(plain, {"dense": dense, "ids": qids}) == (
            404, {"error": "retrieval not enabled"})
    finally:
        for s, t in zip((srv, plain), threads):
            s.shutdown()
            s.server_close()
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)


def test_retrieval_needs_a_two_tower(tmp_path):
    from meepoembedding_tpu import checkpoint as jckpt
    from meepoembedding_tpu.models.dlrm import DLRM as JDLRM
    from meepoembedding_tpu.table.runtime import DynamicEmbeddingTable as JTable

    dlrm = dict(num_dense_features=2, num_sparse_features=2, embedding_dim=16,
                bottom_mlp=(32, 16), top_mlp=(8, 1))
    t = JTable(JTableConfig(**TABLE))
    jckpt.save(str(tmp_path / "ck"), t.spec, [t.shard], 1,
               dense={"params": JDLRM(JModelConfig(**dlrm)).init(jax.random.PRNGKey(0))})
    svc = ScoringService(str(tmp_path / "ck"), TableConfig(**TABLE), ModelConfig(**dlrm),
                         device="cpu")
    with pytest.raises(ValueError, match="two_tower"):
        RetrievalService(svc)
