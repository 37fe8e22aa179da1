"""The scoring service's graph path on the card: a one-hot request replays
its bucket's captured CUDA graph, and answers what the eager path answers.

Every test here is marked `gpu` and skips without a CUDA device (decided
inside the test, never at import). The file imports no JAX; on a machine
with only PyTorch run it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_serving_graph.py
"""

import numpy as np
import pytest
import torch

from meepoembedding_tpu_torch import ScoringService, checkpoint
from meepoembedding_tpu_torch.config import ModelConfig, TableConfig
from meepoembedding_tpu_torch.models import build_model
from meepoembedding_tpu_torch.serving import pad_request, request_bucket
from meepoembedding_tpu_torch.table import hashing
from meepoembedding_tpu_torch.table.runtime import DynamicEmbeddingTable
from meepoembedding_tpu_torch.weights import to_jax_params

torch.set_num_threads(1)

DIM, S, ND, VOCAB = 16, 26, 13, 20_000
TABLE = dict(dim=DIM, capacity=1 << 16)
DLRM = dict(kind="dlrm", num_dense_features=ND, num_sparse_features=S, embedding_dim=DIM,
            bottom_mlp=(64, DIM), top_mlp=(64, 32, 1))
DEEPFM = dict(kind="deepfm", num_dense_features=ND, num_sparse_features=S,
              embedding_dim=DIM, top_mlp=(64, 32, 1))


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph path runs only on the card")
    return torch.device("cuda")


def _save(path, model_cfg, seed: int) -> str:
    """A checkpoint of VOCAB ids with rows and tower weights drawn from
    `seed` (biases nonzero), scaled so that scores spread over (0, 1)."""
    rng = np.random.default_rng(seed)
    t = DynamicEmbeddingTable(TableConfig(**TABLE), device="cpu")
    t.assign(np.arange(1, VOCAB + 1, dtype=np.int64),
             rng.normal(scale=0.1, size=(VOCAB, DIM)).astype(np.float32))
    model = build_model(ModelConfig(**model_cfg), generator=torch.Generator().manual_seed(seed))
    leaves = [x + rng.normal(scale=0.05, size=x.shape).astype(x.dtype)
              for x in to_jax_params(model)]
    checkpoint.save(str(path), t.spec, [t.shard], 0, dense={"params": leaves})
    return str(path)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("graph")
    return {name: _save(d / name, cfg, seed) for name, cfg, seed in
            (("a", DLRM, 1), ("b", DLRM, 2), ("deepfm", DEEPFM, 3))}


def _service(path, model_cfg=DLRM) -> ScoringService:
    return ScoringService(path, TableConfig(**TABLE), ModelConfig(**model_cfg),
                          device=_cuda())


def _request(c: int, seed: int):
    """C candidates, 3% of their ids unknown to the table."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, VOCAB + 1, size=(c, S))
    unknown = rng.random((c, S)) < 0.03
    ids[unknown] = rng.integers(VOCAB + 1, 2**40, size=int(unknown.sum()))
    return rng.normal(size=(c, ND)).astype(np.float32), ids


def _eager(svc, dense, ids):
    with torch.no_grad():
        return svc._eager_score(dense, ids, None, False)


def _padded(dense, ids):
    cp = request_bucket(len(ids))
    dense_p, ids_p = np.empty((cp, ND), np.float32), np.empty((cp, S), np.int64)
    pad_request(dense, ids, dense_p, ids_p)
    return dense_p, ids_p


@pytest.mark.gpu
@pytest.mark.parametrize("c", [1, 128, 129, 700, 2048])
def test_graph_scores_are_the_eager_paths(ckpts, c):
    """Bit for bit the eager path's scores on the same padded input, and
    within 1e-6 of the eager path's on the request as it came."""
    svc = _service(ckpts["a"])
    dense, ids = _request(c, seed=c)
    first = svc.score(dense, ids)  # captures
    again = svc.score(dense, ids)  # replays
    assert (svc.graph_captures, svc.graph_replays, svc.eager_requests) == (1, 1, 0)
    assert first.shape == (c,) and first.dtype == np.float32
    np.testing.assert_array_equal(again, first)
    np.testing.assert_array_equal(first, _eager(svc, *_padded(dense, ids))[:c])
    np.testing.assert_allclose(first, _eager(svc, dense, ids), rtol=0, atol=1e-6)


@pytest.mark.gpu
def test_one_capture_a_bucket_and_a_replay_for_every_later_request(ckpts):
    svc = _service(ckpts["a"])
    sizes = [128, 100, 65, 256, 129, 700, 1024, 2048, 1500, 700]
    for i, c in enumerate(sizes):
        dense, ids = _request(c, seed=100 + i)
        np.testing.assert_allclose(svc.score(dense, ids), _eager(svc, dense, ids), rtol=0,
                                   atol=1e-6)
    buckets = {request_bucket(c) for c in sizes}
    assert buckets == {128, 256, 1024, 2048}
    assert svc.graph_captures == len(buckets)
    assert svc.graph_replays == len(sizes) - len(buckets)
    bags = np.full((4, S, 3), hashing.EMPTY_ID, np.int64)
    bags[:, :, 0] = _request(4, seed=7)[1]
    svc.score(_request(4, seed=7)[0], bags)  # bags take the eager path
    assert svc.eager_requests == 1
    text = svc.metrics_text()
    for line in (f"meepo_graph_replays_total {len(sizes) - 4}",
                 "meepo_graph_captures_total 4", "meepo_eager_requests_total 1",
                 f"meepo_requests_total {len(sizes) + 1}"):
        assert line in text


@pytest.mark.gpu
def test_replaced_table_or_tower_is_captured_anew(ckpts):
    """`reload`, the table's `load` and its growth replace what a graph
    reads, so the next request captures again and serves the new rows; an
    in-place `assign` needs no new capture."""
    svc = _service(ckpts["a"])
    dense, ids = _request(300, seed=11)
    on_a = svc.score(dense, ids)
    svc.reload(ckpts["b"])
    on_b = svc.score(dense, ids)
    assert svc.graph_captures == 2
    assert not np.array_equal(on_a, on_b)
    np.testing.assert_allclose(on_b, _eager(svc, dense, ids), rtol=0, atol=1e-6)
    np.testing.assert_allclose(on_b, _eager(_service(ckpts["b"]), dense, ids), rtol=0,
                               atol=1e-6)

    svc.table.load(ckpts["a"])  # rows of a under the tower of b
    rows_a = svc.score(dense, ids)
    assert svc.graph_captures == 3
    np.testing.assert_allclose(rows_a, _eager(svc, dense, ids), rtol=0, atol=1e-6)

    svc.table._grow()
    assert svc.table.spec.capacity == 2 * TABLE["capacity"]
    np.testing.assert_array_equal(svc.score(dense, ids), rows_a)
    assert svc.graph_captures == 4

    rng = np.random.default_rng(12)
    moved_ids = np.unique(ids[:, 0])
    svc.table.assign(moved_ids, rng.normal(size=(len(moved_ids), DIM)).astype(np.float32))
    moved = svc.score(dense, ids)
    assert (svc.graph_captures, svc.graph_replays) == (4, 1)
    assert not np.array_equal(moved, rows_a)
    np.testing.assert_allclose(moved, _eager(svc, dense, ids), rtol=0, atol=1e-6)


@pytest.mark.gpu
def test_another_one_hot_model_matches_its_eager_scores(ckpts):
    svc = _service(ckpts["deepfm"], DEEPFM)
    for i, c in enumerate((200, 200, 1000)):
        dense, ids = _request(c, seed=200 + i)
        got = svc.score(dense, ids)
        np.testing.assert_array_equal(got, _eager(svc, *_padded(dense, ids))[:c])
        np.testing.assert_allclose(got, _eager(svc, dense, ids), rtol=0, atol=1e-6)
    assert (svc.graph_captures, svc.graph_replays, svc.eager_requests) == (2, 1, 0)


@pytest.mark.gpu
def test_a_forward_that_cannot_be_captured_answers_eagerly(ckpts):
    """A host sync inside the forward fails the capture: the request and
    later ones of its bucket answer eagerly on the stream they came on,
    and other buckets still capture once the forward allows it."""
    svc = _service(ckpts["a"])
    forward = svc.model.forward

    def syncing(dense, emb):
        out = forward(dense, emb)
        float(out.sum())  # a read-back, which a capture refuses
        return out

    svc.model.forward = syncing
    dense, ids = _request(100, seed=21)
    want = _eager(svc, dense, ids)
    np.testing.assert_array_equal(svc.score(dense, ids), want)
    assert torch.cuda.current_stream() == torch.cuda.default_stream()  # given back
    np.testing.assert_array_equal(svc.score(dense, ids), want)
    assert (svc.graph_captures, svc.graph_replays, svc.eager_requests) == (0, 0, 2)
    del svc.model.forward
    np.testing.assert_array_equal(svc.score(dense, ids), want)  # its bucket stays eager
    dense, ids = _request(600, seed=22)
    np.testing.assert_allclose(svc.score(dense, ids), _eager(svc, dense, ids), rtol=0,
                               atol=1e-6)
    assert (svc.graph_captures, svc.graph_replays, svc.eager_requests) == (1, 0, 3)
