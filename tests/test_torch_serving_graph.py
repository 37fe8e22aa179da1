"""The scoring service's graph path on the card: a one-hot request, or one
of fixed-size multi-hot bags (DLRM-DCNv2's), replays its bucket's captured
CUDA graph, and answers what the eager path answers.

The host half (a request's bags written into the bucket's buffer, the
bucket's static bags, which requests take a graph) is tested on the CPU.
Every other test is marked `gpu` and skips without a CUDA device (decided
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
from meepoembedding_tpu_torch.ops import pooling
from meepoembedding_tpu_torch.serving import fixed_bags, pad_request, request_bucket
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
# DLRM-DCNv2's tower and bags (its multi_hot_sizes) at a small width
DCNV2 = dict(kind="dlrm", num_dense_features=ND, num_sparse_features=S, embedding_dim=DIM,
             bottom_mlp=(64, DIM), top_mlp=(64, 32, 1), interaction="dcn",
             num_cross_layers=3, dcn_low_rank_dim=8, combiner="sum")
WIDTHS = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100, 27, 10, 3, 1, 1)
L = 100


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
            (("a", DLRM, 1), ("b", DLRM, 2), ("deepfm", DEEPFM, 3), ("dcnv2", DCNV2, 4),
             ("dcnv2_b", DCNV2, 5))}


def _service(path, model_cfg=DLRM, device=None) -> ScoringService:
    return ScoringService(path, TableConfig(**TABLE), ModelConfig(**model_cfg),
                          device=device or _cuda())


def _request(c: int, seed: int):
    """C candidates, 3% of their ids unknown to the table."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, VOCAB + 1, size=(c, S))
    unknown = rng.random((c, S)) < 0.03
    ids[unknown] = rng.integers(VOCAB + 1, 2**40, size=int(unknown.sum()))
    return rng.normal(size=(c, ND)).astype(np.float32), ids


def _bags(c: int, seed: int, widths=WIDTHS, width: int = L):
    """C candidates of fixed-size bags: [C, S, width] ids, feature s's bag
    its first widths[s] slots, then the invalid id; 3% of the ids unknown.
    Returns (dense, ids, lengths [C, S] int32)."""
    rng = np.random.default_rng(seed)
    s = len(widths)
    ids = rng.integers(1, VOCAB + 1, size=(c, s, width))
    unknown = rng.random(ids.shape) < 0.03
    ids[unknown] = rng.integers(VOCAB + 1, 2**40, size=int(unknown.sum()))
    lengths = np.repeat(np.asarray(widths, np.int32)[None, :], c, axis=0)
    ids[np.arange(width)[None, None, :] >= lengths[..., None]] = hashing.EMPTY_ID
    return rng.normal(size=(c, ND)).astype(np.float32), ids, lengths


def _eager(svc, dense, ids, lengths=None):
    with torch.no_grad():
        return svc._eager_score(dense, ids, lengths, ids.ndim == 3)


def _padded(dense, ids):
    cp = request_bucket(len(ids))
    dense_p, ids_p = np.empty((cp, ND), np.float32), np.empty((cp, S), np.int64)
    pad_request(dense, ids, dense_p, ids_p)
    return dense_p, ids_p


def _padded_bags(dense, ids, lengths):
    """A bag request padded to its bucket as the graph pads it: zero dense
    values, and bags of the same lengths holding only the invalid id."""
    cp, c = request_bucket(len(ids)), len(ids)
    dense_p = np.zeros((cp, ND), np.float32)
    ids_p = np.full((cp,) + ids.shape[1:], hashing.EMPTY_ID, np.int64)
    dense_p[:c], ids_p[:c] = dense, ids
    return dense_p, ids_p, np.concatenate([lengths, np.repeat(lengths[:1], cp - c, axis=0)])


@pytest.mark.parametrize("c,widths", [(1, (3, 0, 2)), (5, (1, 1, 1, 1)), (7, (0, 4)),
                                      (129, WIDTHS)])
def test_fixed_bags_load_as_ragged_ids_and_pool_alike(ckpts, c, widths):
    """The host half of a bag request's graph, on the CPU: its ids written
    into the bucket's [Cp, K] buffer (`pooling.fixed_bag_ids`) are
    `pooling.ragged_ids` followed by the invalid id, its dense values are
    padded with zeros, the bucket's static bags are `pooling.bags_on` of the
    padded lengths, and pooling the buffer (padded on to a power of two)
    gives the real candidates' bags what the eager path's ragged ids give
    them, and the padded ones zeros."""
    width = max(widths) + 2
    dense, ids, lengths = _bags(c, seed=c, widths=widths, width=width)
    cp, k = request_bucket(c), sum(widths)
    dense_out = np.full((cp, ND), np.nan, np.float32)
    ids_out = np.zeros((cp, k), np.int64)
    pad_request(dense, ids, dense_out, ids_out, widths)
    np.testing.assert_array_equal(ids_out.reshape(-1)[:c * k],
                                  pooling.ragged_ids(ids, lengths).numpy())
    assert (ids_out[c:] == hashing.EMPTY_ID).all()
    np.testing.assert_array_equal(dense_out[:c], dense)
    assert (dense_out[c:] == 0).all()

    bags = fixed_bags(cp, widths, "cpu", "sum")
    want = pooling.bags_on(_padded_bags(dense, ids, lengths)[2], cp * k, "cpu", "sum")
    assert torch.equal(bags.of, want.of) and torch.equal(bags.lengths, want.lengths)

    model = dict(DCNV2, num_sparse_features=len(widths))
    svc = ScoringService(_save(ckpts["dcnv2"] + f"-{c}", model, seed=4), TableConfig(**TABLE),
                         ModelConfig(**model), device="cpu")
    flat = torch.full((request_bucket(cp * k),), hashing.EMPTY_ID, dtype=torch.int64)
    flat[:cp * k] = torch.from_numpy(ids_out.reshape(-1))
    pooled = svc._pool(flat, bags).view(cp, len(widths), DIM)
    eager, shape = svc._pooled(ids, lengths)
    assert shape == (c, len(widths))
    assert torch.equal(pooled[:c], eager.view(c, len(widths), DIM))
    assert not pooled[c:].any()


def _selection_cases():
    dense, ids, lengths = _bags(6, seed=3)
    mixed = lengths.copy()
    mixed[2, 4] -= 1
    zero = np.zeros_like(lengths)
    long = lengths.copy()
    long[:, 20] = L + 1
    one_hot = ids[:, :, 0]
    key = (8, ND, WIDTHS)
    return [
        ("bags", DCNV2, dense, ids, lengths, "none", key),
        ("bags_as_a_list", DCNV2, dense, ids, lengths.tolist(), "none", key),
        ("bags_as_a_tensor", DCNV2, dense, ids, torch.from_numpy(lengths), "none", key),
        ("one_hot", DCNV2, dense, one_hot, None, "none", (8, S, ND)),
        ("mixed_lengths", DCNV2, dense, ids, mixed, "none", None),
        ("no_lengths", DCNV2, dense, ids, None, "none", None),
        ("no_ids_at_all", DCNV2, dense, ids, zero, "none", None),
        ("longer_than_the_bags", DCNV2, dense, ids, long, "none", None),
        ("int8", DCNV2, dense, ids, lengths, "int8", None),
        ("din", dict(DCNV2, kind="din"), dense, ids, lengths, "none", None),
        ("bst", dict(DCNV2, kind="bst"), dense, ids, lengths, "none", None),
        ("two_tower", dict(DCNV2, kind="two_tower"), dense, ids, lengths, "none", None),
    ]


@pytest.mark.parametrize("case", _selection_cases(), ids=lambda case: case[0])
def test_which_requests_take_a_graph(ckpts, case):
    """The graph key of a request, on a CPU service that calls its device a
    card: fixed-size bags and one-hot ids get one, keyed apart; bags of
    differing lengths or without `lengths`, models that pool inside or key
    items by their bags and the int8 table go the eager way. On the CPU
    itself every request goes the eager way."""
    _, model, dense, ids, lengths, quantize, want = case
    svc = ScoringService(ckpts["dcnv2"], TableConfig(**TABLE), ModelConfig(**DCNV2),
                         quantize=quantize, device="cpu")
    assert svc._graph_key(dense, ids, lengths) is None
    svc.model = build_model(ModelConfig(**model))
    svc.device = torch.device("cuda")  # a name only: nothing runs on it
    assert svc._graph_key(dense, ids, lengths) == want


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


@pytest.mark.gpu
@pytest.mark.parametrize("c", [1, 128, 129, 700, 2048])
def test_bag_graph_scores_are_the_eager_paths(ckpts, c):
    """A request of DLRM-DCNv2's fixed-size bags: bit for bit the eager
    path's scores on the same padded input, and within 1e-6 of the eager
    path's on the request as it came."""
    svc = _service(ckpts["dcnv2"], DCNV2)
    dense, ids, lengths = _bags(c, seed=c)
    first = svc.score(dense, ids, lengths=lengths)  # captures
    again = svc.score(dense, ids, lengths=lengths)  # replays
    assert (svc.graph_captures, svc.graph_replays, svc.eager_requests) == (1, 1, 0)
    assert first.shape == (c,) and first.dtype == np.float32
    np.testing.assert_array_equal(again, first)
    np.testing.assert_array_equal(first, _eager(svc, *_padded_bags(dense, ids, lengths))[:c])
    np.testing.assert_allclose(first, _eager(svc, dense, ids, lengths), rtol=0, atol=1e-6)


@pytest.mark.gpu
def test_bags_capture_once_a_bucket_and_keep_apart_from_one_hot_and_eager(ckpts):
    """One capture a bucket, then replays with `eager_requests` flat; a
    one-hot request of a bucket that bags use keeps its own graph; bags of
    differing lengths, and bags without `lengths`, answer eagerly with the
    eager path's scores."""
    svc = _service(ckpts["dcnv2"], DCNV2)
    sizes = [128, 100, 65, 256, 129, 700, 1024, 2048, 1500, 700]
    for i, c in enumerate(sizes):
        dense, ids, lengths = _bags(c, seed=300 + i)
        np.testing.assert_allclose(svc.score(dense, ids, lengths=lengths),
                                   _eager(svc, dense, ids, lengths), rtol=0, atol=1e-6)
    buckets = {request_bucket(c) for c in sizes}
    assert (svc.graph_captures, svc.graph_replays, svc.eager_requests) == (
        len(buckets), len(sizes) - len(buckets), 0)

    dense, ids, lengths = _bags(200, seed=320)
    one_hot = ids[:, :, 0]
    for _ in range(2):
        np.testing.assert_allclose(svc.score(dense, one_hot), _eager(svc, dense, one_hot),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(svc.score(dense, ids, lengths=lengths),
                                   _eager(svc, dense, ids, lengths), rtol=0, atol=1e-6)
    assert (256, S, ND) in svc._graphs and (256, ND, WIDTHS) in svc._graphs
    assert (svc.graph_captures, svc.eager_requests) == (len(buckets) + 1, 0)

    mixed = lengths.copy()
    mixed[::3, 20] = 40
    ids_mixed = ids.copy()
    ids_mixed[np.arange(L)[None, None, :] >= mixed[..., None]] = hashing.EMPTY_ID
    want_mixed = _eager(svc, dense, ids_mixed, mixed)
    np.testing.assert_array_equal(svc.score(dense, ids_mixed, lengths=mixed), want_mixed)
    np.testing.assert_array_equal(svc.score(dense, ids), _eager(svc, dense, ids))
    assert (svc.graph_captures, svc.eager_requests) == (len(buckets) + 1, 2)


@pytest.mark.gpu
def test_bag_graphs_are_captured_anew_after_reload(ckpts):
    svc = _service(ckpts["dcnv2"], DCNV2)
    dense, ids, lengths = _bags(300, seed=330)
    on_a = svc.score(dense, ids, lengths=lengths)
    svc.reload(ckpts["dcnv2_b"])
    on_b = svc.score(dense, ids, lengths=lengths)
    assert (svc.graph_captures, svc.graph_replays) == (2, 0)
    assert not np.array_equal(on_a, on_b)
    np.testing.assert_allclose(on_b, _eager(svc, dense, ids, lengths), rtol=0, atol=1e-6)
    np.testing.assert_allclose(on_b, _eager(_service(ckpts["dcnv2_b"], DCNV2), dense, ids,
                                            lengths), rtol=0, atol=1e-6)
