"""BST and DIN on positional ragged bags: a model that pools inside, given
the bags' `lengths`, gets only the valid ids into the table
(`pooling.positional_batch`), and `dedup.GatherRows` lays their rows at
their places of a zero [B, S, L, dim] input (`pooling.Positions`).

Held against the padded path (bit-equal forward, table gradients within the
summation-order bound) and against the benchmark's plain reference
(`benchmark/reference/bst.py`, loaded by path) on seeded random weights at
a small size: the forward, three `Trainer` steps and
`ScoringService.score(..., lengths=)` with unknown ids. Spies show that no
padding id reaches the id split, the dedup, the probe or the sparse
update. The tests marked `gpu` run the positional gather on the card and
three steps at the BST configuration's widths, and skip without one.
"""

import importlib
import importlib.util
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from meepoembedding_tpu_torch import checkpoint
from meepoembedding_tpu_torch.config import ModelConfig, OptimizerConfig, RunConfig, TableConfig
from meepoembedding_tpu_torch.models import build_model
from meepoembedding_tpu_torch.ops import dedup, optim, pooling
from meepoembedding_tpu_torch.serving import ScoringService
from meepoembedding_tpu_torch.table import hashing, table_ops
from meepoembedding_tpu_torch.table.layout import TableSpec, alloc_shard
from meepoembedding_tpu_torch.train import Trainer
from meepoembedding_tpu_torch.weights import from_jax_params, param_leaves, to_jax_params

torch.set_num_threads(2)

REFERENCE = Path(__file__).resolve().parents[1] / "benchmark" / "reference"
B, S, L, D = 16, 4, 6, 8
MODEL = dict(kind="bst", num_dense_features=3, num_sparse_features=S, embedding_dim=D,
             attention_heads=2, transformer_blocks=2, max_seq_len=L + 1, top_mlp=(16, 8, 1),
             combiner="mean")
DIN = dict(MODEL, kind="din", attention_mlp=(8,))
OPT = dict(learning_rate=0.05, initial_accumulator=0.1, eps=1e-8)
DENSE_OPT = dict(learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-8)


def _reference():
    """`reference.bst` of the benchmark's reference package, loaded by path."""
    if "perf_reference" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "perf_reference", REFERENCE / "__init__.py",
            submodule_search_locations=[str(REFERENCE)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules["perf_reference"] = mod
        spec.loader.exec_module(mod)
    return importlib.import_module("perf_reference.bst")


def _mc(model: dict) -> ModelConfig:
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in model.items()})


def _leaves(model: dict, seed: int):
    """Random leaves as `leaf_specs` draws them, biases nonzero."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g) * (std or 0.1)
            for shape, std in _reference().leaf_specs(model)]


def _bags(seed: int, n: int = B, empty: bool = True):
    """Padded ids [n, S, L] (a small vocabulary, so ids repeat) and lengths
    [n, S]: the target's bag of one, the other bags 0..L long (1..L without
    `empty`)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0 if empty else 1, L + 1, (n, S)).astype(np.int32)
    lengths[:, 0] = 1
    vals = rng.integers(0, 30, (n, S, L))
    ids = (np.arange(S, dtype=np.int64)[None, :, None] << 44) | vals
    ids[np.arange(L)[None, None, :] >= lengths[..., None]] = hashing.EMPTY_ID
    return ids, lengths


def _batch(seed: int, model: dict = MODEL) -> dict:
    rng = np.random.default_rng(seed + 1000)
    ids, lengths = _bags(seed)
    return {"ids": ids, "lengths": lengths,
            "dense": rng.standard_normal((B, model["num_dense_features"]), dtype=np.float32),
            "label": (rng.random(B) < 0.3).astype(np.float32)}


def _padded(b: dict) -> dict:
    return {k: v for k, v in b.items() if k != "lengths"}


def _valid(b: dict) -> np.ndarray:
    return b["ids"][np.arange(L)[None, None, :] < b["lengths"][..., None]]


def _trainer(model: dict, leaves=None) -> Trainer:
    tc = TableConfig(dim=D, capacity=1 << 12, initializer_scale=0.01,
                     optimizer=OptimizerConfig(kind="rowwise_adagrad", **OPT))
    tr = Trainer(RunConfig(batch_size=B, dense_learning_rate=DENSE_OPT["learning_rate"]),
                 tc, _mc(model), device="cpu", generator=torch.Generator().manual_seed(2))
    if leaves is not None:
        from_jax_params(tr.model, [x.numpy() for x in leaves])
    return tr


def _rows(tr: Trainer, ids: np.ndarray) -> torch.Tensor:
    hi, lo = hashing.split_ids_t(torch.from_numpy(ids).to(tr.shard.values.device))
    pr = table_ops.probe(tr.spec, tr.shard, hi, lo, hashing.is_valid(hi, lo))
    assert bool(pr.found.all())
    return table_ops.lookup_rows(tr.shard, pr.slot).float()


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def _service(model: dict, leaves) -> ScoringService:
    """A CPU scoring service of a checkpoint holding `leaves` (tensors or
    arrays) and an empty table."""
    tc = TableConfig(dim=D, capacity=1 << 12)
    tiny = TableSpec.from_config(tc)
    path = tempfile.mkdtemp(prefix="bst-ckpt-")
    try:
        checkpoint.save(path, tiny, [alloc_shard(tiny, "cpu")], 0,
                        dense={"params": [np.asarray(x) for x in leaves]})
        return ScoringService(path, tc, _mc(model), device="cpu")
    finally:
        shutil.rmtree(path, ignore_errors=True)


def test_the_paths_by_model_and_lengths():
    """Positional bags: a model that pools inside, given lengths; pooled
    bags keep `takes_ragged`; the two-tower and bags without lengths are
    padded."""
    ids, lengths = _bags(1)
    bst, din = build_model(_mc(MODEL)), build_model(_mc(DIN))
    dlrm = build_model(ModelConfig(num_dense_features=3, num_sparse_features=S,
                                   embedding_dim=D, bottom_mlp=(8, D), top_mlp=(8, 1)))
    tower = build_model(ModelConfig(kind="two_tower", num_dense_features=3,
                                    num_sparse_features=S, embedding_dim=D, top_mlp=(8, D)))
    assert pooling.takes_positional(bst, ids, lengths)
    assert pooling.takes_positional(din, torch.from_numpy(ids), lengths)
    assert not pooling.takes_positional(bst, ids, None)
    assert not pooling.takes_positional(bst, ids[:, :, 0], lengths)
    assert not pooling.takes_positional(dlrm, ids, lengths)
    assert not pooling.takes_positional(tower, ids, lengths)
    assert not pooling.takes_ragged(bst, ids) and pooling.takes_ragged(dlrm, ids)


@pytest.mark.parametrize("fixed", [False, True], ids=["bags_of_any_length", "fixed_size"])
def test_positional_batch_takes_the_valid_ids_at_their_places(fixed):
    """Bags of differing lengths and fixed-size bags (one length a feature
    on every row) alike: the valid ids in order, their places, increasing,
    and the validity from the lengths; lengths outside [0, L] refused."""
    ids, lengths = _bags(2)
    if fixed:
        lengths = np.repeat(np.asarray([[1, 4, 0, 6]], np.int32), B, axis=0)
        ids = np.where(np.arange(L)[None, None, :] < lengths[..., None], ids | 7,
                       hashing.EMPTY_ID)
    flat, pos = pooling.positional_batch(ids, lengths, "cpu")
    keep = np.arange(L)[None, None, :] < lengths[..., None]
    assert np.array_equal(flat.numpy(), ids[keep])
    assert pos.at.dtype == torch.int32
    assert np.array_equal(pos.at.numpy(), np.flatnonzero(keep))
    assert np.array_equal(pos.valid.numpy(), keep)
    with pytest.raises(ValueError):
        pooling.positional_batch(ids, np.full((B, S), L + 1, np.int32), "cpu")


def test_positional_gather_lays_rows_out_and_sums_their_gradients():
    """GatherRows with `Positions`: forward the padded path's gather of the
    same ids, bit for bit (zero rows under padding); backward the padded
    path's segment sum over the valid ids' unique rows, within the
    summation-order bound (the same order here, so equal)."""
    ids, lengths = _bags(3)
    flat, pos = pooling.positional_batch(ids, lengths, "cpu")
    hi, lo = hashing.split_ids_t(flat)
    u = dedup.unique_pairs(hi, lo, flat.shape[0])
    g = torch.Generator().manual_seed(3)
    rows = torch.randn((flat.shape[0], D), generator=g)
    rows[int(u.count):] = 0
    w = torch.randn((B * S * L, D), generator=g)
    r1 = rows.clone().requires_grad_(True)
    out = dedup.GatherRows.apply(r1, u.inverse, u.order, u.sorted_ids, pos)
    (out * w).sum().backward()
    # the padded path: every slot's id, padding's unique row zero
    phi, plo = hashing.split_ids_t(torch.from_numpy(ids).reshape(-1))
    pu = dedup.unique_pairs(phi, plo, B * S * L)
    assert int(pu.count) == int(u.count)
    assert torch.equal(pu.hi[:int(u.count)], u.hi[:int(u.count)])
    prows = torch.zeros((B * S * L, D))
    prows[:int(u.count)] = rows[:int(u.count)]
    r2 = prows.requires_grad_(True)
    padded = dedup.GatherRows.apply(r2, pu.inverse, pu.order, pu.sorted_ids)
    (padded * w).sum().backward()
    assert torch.equal(out.detach(), padded.detach())
    assert not out.detach()[~pos.valid.reshape(-1)].any()
    torch.testing.assert_close(r1.grad[:int(u.count)], r2.grad[:int(u.count)], rtol=1e-6,
                               atol=1e-7)
    assert not r1.grad[int(u.count):].any()


@pytest.mark.parametrize("model", [MODEL, DIN], ids=["bst", "din"])
def test_positional_and_padded_paths_train_alike(model):
    """The same batches with and without `lengths`: bit-equal forward
    (losses and eval logits) and tower; table rows within the
    summation-order bound of the gradient's segment sum."""
    pos, pad = _trainer(model), _trainer(model)
    for s in (21, 22, 23):
        b = _batch(s, model)
        assert pos.train_step(b)["loss"] == pad.train_step(_padded(b))["loss"]
    for p, q in zip(pos.params, pad.params):
        assert torch.equal(p, q)
    ids = np.unique(np.concatenate([_valid(_batch(s, model)) for s in (21, 22, 23)]))
    torch.testing.assert_close(_rows(pos, ids), _rows(pad, ids), rtol=1e-6, atol=1e-9)
    b = _batch(24, model)
    assert torch.equal(pos.eval_step(b)["logits"], pad.eval_step(_padded(b))["logits"])


def test_no_padding_reaches_the_table(monkeypatch):
    """A positional step and eval step split, deduplicate, probe and update
    exactly the sum(lengths) valid ids: no call sees the invalid id, and the
    dedup's capacity (what the probe and the update get) is n, not B S L."""
    tr = _trainer(MODEL)
    seen = {"split": [], "dedup": [], "lookup": [], "probe": [], "update": []}

    def spy(name, mod, attr, take):
        fn = getattr(mod, attr)

        def call(*a, **k):
            seen[name].append(take(*a, **k))
            return fn(*a, **k)
        monkeypatch.setattr(mod, attr, call)

    spy("split", hashing, "split_ids_t", lambda ids, *a: ids.clone())
    spy("dedup", dedup, "unique_pairs", lambda hi, lo, size, *a: (hi.clone(), lo.clone(), size))
    spy("lookup", table_ops, "lookup_train", lambda spec, shard, hi, *a: hi.shape[0])
    spy("probe", table_ops, "lookup_probe", lambda spec, shard, hi, *a, **k: hi.shape[0])
    spy("update", optim, "apply_sparse_grads_ctx", lambda spec, shard, ctx, g: g.shape[0])
    step, ev = _batch(31), _batch(32)
    tr.train_step(step)
    tr.eval_step(ev)
    n = [int(step["lengths"].sum()), int(ev["lengths"].sum())]
    assert n[0] != n[1] and seen["split"]
    for ids in seen["split"]:
        assert (ids != hashing.EMPTY_ID).all()
    assert [size for _, _, size in seen["dedup"]] == n
    for hi, lo, size in seen["dedup"]:
        assert hi.shape[0] == size and bool(hashing.is_valid(hi, lo).all())
    assert seen["lookup"] == n[:1] and seen["update"] == n[:1] and seen["probe"] == n[1:]


def test_forward_matches_the_reference():
    """The port's BST on rows at their places against the plain one on the
    same leaves, with empty bags among them."""
    ref = _reference()
    leaves = _leaves(MODEL, seed=3)
    net = from_jax_params(build_model(_mc(MODEL)), [x.numpy() for x in leaves])
    assert [tuple(p.shape[::-1]) if t else tuple(p.shape) for p, t in param_leaves(net)] == [
        s for s, _ in ref.leaf_specs(MODEL)]
    ids, lengths = _bags(4)
    rows = torch.randn((int(lengths.sum()), D), generator=torch.Generator().manual_seed(4))
    emb, valid = ref.layout(rows, lengths)
    dense = torch.randn((B, 3), generator=torch.Generator().manual_seed(5))
    got = net(dense, emb, valid)
    with ref.precision("float32"):
        want = ref.forward(MODEL, leaves, dense, emb, valid)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # one-hot rows are bags of one
    onehot = torch.randn((B, S, D), generator=torch.Generator().manual_seed(6))
    torch.testing.assert_close(net(dense, onehot), torch.logit(ref.score(
        MODEL, leaves, dense, onehot)), rtol=1e-4, atol=1e-5)


def test_macs_count_the_published_block():
    """At the configuration's widths (d 64, T 21, top 1024-512-256-1 over a
    256-wide input): projections 344,064, attention 56,448, FFN 688,128,
    top 917,760."""
    model = dict(embedding_dim=64, max_seq_len=21, transformer_blocks=1,
                 num_dense_features=0, num_sparse_features=4, top_mlp=[1024, 512, 256, 1])
    assert _reference().macs_per_example(model) == 344_064 + 56_448 + 688_128 + 917_760


def test_three_trainer_steps_match_the_reference():
    """Losses, the first step's tower gradients (from Adam's first moment)
    and the table's rows after three steps, against the plain reference's
    steps (float64) from the same leaves and the table's own init rows.
    Tolerances: the program runs in float32 and the reference in float64,
    so each number carries float32 rounding through two encoder blocks,
    softmax and LayerNorm: losses to 1e-5 relative, gradients and the rows'
    change to 1e-4 of the leaf's largest entry (the tower's ReLU units can
    flip under rounding)."""
    ref = _reference()
    leaves = _leaves(MODEL, seed=5)
    tr = _trainer(MODEL, leaves)
    batches = [_batch(s) for s in (11, 12, 13)]
    losses = [tr.train_step(batches[0])["loss"]]
    grads = [m / (1 - DENSE_OPT["b1"]) for m in tr.opt_state[0]]
    losses += [tr.train_step(b)["loss"] for b in batches[1:]]

    def start_rows(ids):
        return torch.from_numpy(ref.init_rows(ids, D, 0.01))

    out = ref.train(MODEL, {"optimizer": OPT}, DENSE_OPT, leaves,
                    [{**b, "ids": _valid(b)} for b in batches], start_rows, "cpu")
    np.testing.assert_allclose(losses, out["losses"], rtol=1e-5)
    for (p, transposed), g, want in zip(param_leaves(tr.model), grads, out["grad1"]):
        assert _rel(g.t() if transposed else g, want) < 1e-4, p.shape
    rows = _rows(tr, out["ids"])
    start = start_rows(out["ids"])
    assert _rel(rows - start, out["change_table"]) < 1e-4
    torch.testing.assert_close(rows, (start + out["change_table"]).float(), rtol=1e-5,
                               atol=1e-7)


def test_score_with_lengths_matches_the_reference(monkeypatch):
    """`score(dense, ids, lengths=)`: known ids read the rows assigned,
    unknown ids zero rows, at their places; against the plain reference, and
    the same scores as the padded request. The table's unique lookup gets
    the valid ids alone, and `/metrics` exports the counters."""
    ref = _reference()
    leaves = _leaves(MODEL, seed=7)
    svc = _service(MODEL, leaves)
    ids, lengths = _bags(33)
    valid = _valid({"ids": ids, "lengths": lengths})
    uniq = np.unique(valid)
    known = uniq[np.random.default_rng(0).random(len(uniq)) < 0.8]
    rows = torch.randn((len(known), D), generator=torch.Generator().manual_seed(8))
    assert svc.table.assign(known, rows).all()
    dense = np.random.default_rng(9).standard_normal((B, 3), dtype=np.float32)
    probed = []
    lookup = svc.table.lookup_unique
    monkeypatch.setattr(svc.table, "lookup_unique",
                        lambda x: probed.append(np.asarray(x)) or lookup(x))
    got = svc.score(dense, ids, lengths=lengths)
    assert len(probed) == 1 and np.array_equal(probed[0], valid)
    assert (svc.positional_ids, svc.positional_padding) == (len(valid), ids.size - len(valid))
    at = np.searchsorted(known, valid)
    hit = known[np.minimum(at, len(known) - 1)] == valid
    assert 0 < hit.sum() < len(valid)  # some unknown ids
    ragged_rows = torch.where(torch.from_numpy(hit)[:, None],
                              rows[torch.from_numpy(np.minimum(at, len(known) - 1))], 0.0)
    with ref.precision("float32"):
        want = ref.score(MODEL, leaves, torch.from_numpy(dense), ragged_rows, lengths)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-6)
    # without lengths the padding reads zero rows: the same scores
    assert np.array_equal(svc.score(dense, ids), got)
    assert svc.eager_requests == 2 and svc.graph_replays == svc.graph_captures == 0
    text = svc.metrics_text()
    assert f"meepo_positional_ids_total {len(valid)}\n" in text
    assert f"meepo_positional_padding_total {ids.size - len(valid)}\n" in text


@pytest.mark.parametrize("model", [MODEL, DIN], ids=["bst", "din"])
def test_pooling_inside_requests_keep_out_of_the_graphs(model):
    """On a service that calls its device a card, a pooling-inside request
    with lengths takes no graph; one-hot and pooled-bag requests keep their
    keys."""
    svc = _service(model, to_jax_params(build_model(_mc(model))))
    ids, lengths = _bags(41, empty=False)
    fixed = np.full_like(lengths, 2)
    dense = np.zeros((B, 3), np.float32)
    svc.device = torch.device("cuda")  # a name only: nothing runs on it
    assert svc._graph_key(dense, ids, lengths) is None
    assert svc._graph_key(dense, ids, fixed) is None
    assert svc._graph_key(dense, ids[:, :, 0], None) == (B, S, 3)
    svc.model = build_model(ModelConfig(num_dense_features=3, num_sparse_features=S,
                                        embedding_dim=D, bottom_mlp=(8, D), top_mlp=(8, 1)))
    assert svc._graph_key(dense, ids, fixed) == (B, 3, (2,) * S)


def test_the_trainer_and_service_take_the_positional_path():
    """Both entry points count sum(lengths) ids and the rest of the slots as
    padding kept out for BST bags with lengths, and nothing for bags
    without them, each in its own counters."""
    tr = _trainer(MODEL)
    b = _batch(51)
    n, slots = int(b["lengths"].sum()), B * S * L
    counts = []

    def count(obj, fn, *a, **k):
        before = (obj.positional_ids, obj.positional_padding)
        fn(*a, **k)
        counts.append((obj.positional_ids - before[0], obj.positional_padding - before[1]))

    count(tr, tr.train_step, b)
    count(tr, tr.train_step, _padded(b))
    svc = _service(MODEL, to_jax_params(tr.model))
    count(svc, svc.score, b["dense"], b["ids"], lengths=b["lengths"])
    count(svc, svc.score, b["dense"], b["ids"])
    assert counts == [(n, slots - n), (0, 0)] * 2
    assert (tr.positional_ids, svc.positional_ids) == (n, n)


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_positional_gather_on_card_matches_cpu():
    """GatherRows with `Positions`, forward and backward, on the card (K1's
    segment-sum walk both ways) and on the CPU: the forward bit for bit,
    the backward within the summation-order bound."""
    dev = _cuda()
    g = torch.Generator().manual_seed(1)
    Bb, Sb, Lb, U = 4096, 4, 20, 30_000
    lengths = torch.randint(0, Lb + 1, (Bb, Sb), generator=g, dtype=torch.int32)
    keep = torch.arange(Lb)[None, None, :] < lengths[..., None]
    at = torch.nonzero(keep.reshape(-1)).reshape(-1).to(torch.int32)
    inv = torch.randint(0, U, (at.shape[0],), generator=g, dtype=torch.int32)
    rows = torch.randn((U, 64), generator=g)
    w = torch.randn((Bb * Sb * Lb, 64), generator=g)
    out = []
    for d in ("cpu", dev):
        r = rows.detach().to(d).requires_grad_(True)
        pos = pooling.Positions(at=at.to(d), valid=keep.to(d))
        laid = dedup.GatherRows.apply(r, inv.to(d), None, None, pos)
        (laid * w.to(d)).sum().backward()
        out.append((laid.detach().cpu(), r.grad.cpu()))
    assert torch.equal(out[1][0], out[0][0])
    torch.testing.assert_close(out[1][1], out[0][1], rtol=1e-5, atol=1e-5)


def _gaps(got: dict, want: dict) -> dict:
    """Loss: each step's relative gap. First gradients: per tower leaf,
    max |g - g_ref| over max |g_ref|; their worst and median."""
    leaf = [_rel(a, b) for a, b in zip(got["grad1"], want["grad1"])]
    return {"loss_gaps": [abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])],
            "grad_gap_worst": max(leaf), "grad_gap_median": float(np.median(leaf))}


@pytest.mark.gpu
def test_three_steps_at_the_configuration_widths_on_card():
    """Three `Trainer` steps of BST at the bst-taobao configuration's widths
    (d 64, 8 heads, 1 block, 20 behaviours, top 1024-512-256-1, no dense
    features) at B 8192 on the positional path, against the reference in
    float64 from the same leaves and init rows; the TF32 control (the
    reference in float32 with TF32 matmuls) beside it. Tolerances: the
    first loss 1e-5 and the first gradients 1e-3 of each leaf's largest
    entry (float32 rounding carried through the encoder and a 1024-wide
    MLP); the later losses 2e-4 and the rows' change after 3 steps 1e-3,
    as Adam's first update moves each weight by about its learning rate in
    the direction of its gradient's sign, which flips under rounding where
    the gradient sits near zero (the card read 4.95e-5 on the losses and
    1.7e-4 on the rows, the control 6.4e-4 and 1.4e-3). The program's
    median leaf must read a tenth of the control's or less."""
    dev = _cuda()
    ref = _reference()
    model = dict(kind="bst", num_dense_features=0, num_sparse_features=4, embedding_dim=64,
                 attention_heads=8, transformer_blocks=1, max_seq_len=21,
                 top_mlp=[1024, 512, 256, 1], combiner="mean")
    g = torch.Generator().manual_seed(11)
    leaves = [torch.randn(shape, generator=g) * std for shape, std in ref.leaf_specs(model)]
    tc = TableConfig(dim=64, capacity=1 << 22, initializer_scale=0.01,
                     optimizer=OptimizerConfig(kind="rowwise_adagrad", **OPT))
    tr = Trainer(RunConfig(batch_size=8192, dense_learning_rate=DENSE_OPT["learning_rate"]),
                 tc, _mc(model), device=dev)
    from_jax_params(tr.model, [x.numpy() for x in leaves])
    rng = np.random.default_rng(12)
    sizes, cards = np.array([1, 20, 1, 1]), np.array([4_162_024, 4_162_024, 987_994, 9_439])
    lengths = np.repeat(sizes[None, :].astype(np.int32), 8192, axis=0)
    batches = []
    for _ in range(3):
        vals = np.minimum(rng.zipf(1.05, (8192, 4, 20)), cards[None, :, None]) - 1
        ids = (np.arange(4, dtype=np.int64)[None, :, None] << 44) | vals
        ids[np.arange(20)[None, None, :] >= lengths[..., None]] = hashing.EMPTY_ID
        batches.append({"ids": ids, "lengths": lengths,
                        "dense": np.zeros((8192, 0), np.float32),
                        "label": (rng.random(8192) < 0.256).astype(np.float32)})
    losses = [tr.train_step(batches[0])["loss"]]
    assert (tr.positional_ids, tr.positional_padding) == (8192 * 23, 8192 * 57)
    grads = [m / (1 - DENSE_OPT["b1"]) for m in tr.opt_state[0]]
    grads = [g.t() if t else g for g, (_, t) in zip(grads, param_leaves(tr.model))]
    losses += [tr.train_step(b)["loss"] for b in batches[1:]]
    ragged = [{**b, "ids": b["ids"][np.arange(20)[None, None, :] < b["lengths"][..., None]]}
              for b in batches]

    def start_rows(ids):
        return torch.from_numpy(ref.init_rows(ids, 64, 0.01))

    want = ref.train(model, {"optimizer": OPT}, DENSE_OPT, leaves, ragged, start_rows, dev)
    ctrl = ref.train(model, {"optimizer": OPT}, DENSE_OPT, leaves, ragged, start_rows, dev,
                     kind="tf32")
    # the step keeps no table gradient: the rows' change after 3 steps
    # stands for it, as the reference gives that change
    rows = _rows(tr, want["ids"]) - start_rows(want["ids"]).to(dev)
    prog = _gaps({"losses": losses, "grad1": grads}, want)
    prog["table_change_gap"] = _rel(rows, want["change_table"])
    control = _gaps(ctrl, want)
    control["table_change_gap"] = _rel(ctrl["change_table"], want["change_table"])
    print(f"\nbst three steps at B 8192: program {prog}; control {control}")
    assert prog["loss_gaps"][0] < 1e-5 and max(prog["loss_gaps"]) < 2e-4
    assert prog["grad_gap_worst"] < 1e-3 and prog["table_change_gap"] < 1e-3
    assert prog["grad_gap_median"] < control["grad_gap_median"] / 10
