"""MLPerf DLRM-DCNv2 on the port: `dlrm` with `interaction="dcn"` (a
low-rank cross net) and ragged multi-hot bags (`lengths` beside the padded
ids), pooled inside `dedup.GatherRows`.

Held against the benchmark's plain reference (`benchmark/reference/
dlrm_dcnv2.py`, loaded by path) on seeded random weights at a small size:
the forward, three `Trainer` steps (losses, tower gradients, table rows) and
`ScoringService.score(..., lengths=)` with unknown ids. The ragged and the
padded path give the same losses and updates for every combiner, and
`interaction="dot"` is the DLRM it was. The tests marked `gpu` run the
pooling's kernel and the tower on the card, and skip without one.
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
from meepoembedding_tpu_torch.kernels import row_merge_add, segment_size, segment_sum_gather
from meepoembedding_tpu_torch.models import build_model
from meepoembedding_tpu_torch.ops import dedup, pooling
from meepoembedding_tpu_torch.serving import ScoringService
from meepoembedding_tpu_torch.table import hashing, table_ops
from meepoembedding_tpu_torch.table.layout import TableSpec, alloc_shard
from meepoembedding_tpu_torch.train import Trainer
from meepoembedding_tpu_torch.weights import from_jax_params, param_leaves

torch.set_num_threads(2)

REFERENCE = Path(__file__).resolve().parents[1] / "benchmark" / "reference"
B, S, L, D, ND = 16, 4, 7, 8, 5
MODEL = dict(kind="dlrm", num_dense_features=ND, num_sparse_features=S, embedding_dim=D,
             bottom_mlp=(16, D), top_mlp=(16, 1), interaction="dcn", num_cross_layers=2,
             dcn_low_rank_dim=4, combiner="sum")
OPT = dict(learning_rate=0.05, initial_accumulator=0.1, eps=1e-8)
DENSE_OPT = dict(learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-8)


def _reference(name: str):
    """A module of the benchmark's reference package, loaded by path."""
    if "perf_reference" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "perf_reference", REFERENCE / "__init__.py",
            submodule_search_locations=[str(REFERENCE)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules["perf_reference"] = mod
        spec.loader.exec_module(mod)
    return importlib.import_module(f"perf_reference.{name}")


def _model(**over) -> dict:
    return {**{k: list(v) if isinstance(v, tuple) else v for k, v in MODEL.items()}, **over}


def _leaves(ref, model: dict, seed: int = 0):
    """Random leaves as `leaf_specs` draws them, biases nonzero."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g) * (std or 0.1) for shape, std in
            ref.leaf_specs(model)]


def _bags(seed: int, empty: bool = True):
    """Padded ids [B, S, L] (a small vocabulary, so ids repeat) and lengths
    [B, S] in 0..L (1..L without `empty`)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0 if empty else 1, L + 1, (B, S)).astype(np.int32)
    vals = rng.integers(0, 40, (B, S, L))
    ids = (np.arange(S, dtype=np.int64)[None, :, None] << 44) | vals
    ids[np.arange(L)[None, None, :] >= lengths[..., None]] = hashing.EMPTY_ID
    return ids, lengths


def _batch(seed: int, empty: bool = True) -> dict:
    rng = np.random.default_rng(seed + 1000)
    ids, lengths = _bags(seed, empty)
    return {"ids": ids, "lengths": lengths,
            "dense": rng.standard_normal((B, ND), dtype=np.float32),
            "label": (rng.random(B) < 0.3).astype(np.float32)}


def _trainer(model: dict, leaves) -> Trainer:
    mc = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in model.items()})
    tc = TableConfig(dim=D, capacity=1 << 12, initializer_scale=0.01,
                     optimizer=OptimizerConfig(kind="rowwise_adagrad", **OPT))
    tr = Trainer(RunConfig(batch_size=B, dense_learning_rate=DENSE_OPT["learning_rate"]),
                 tc, mc, device="cpu")
    from_jax_params(tr.model, [x.numpy() for x in leaves])
    return tr


def _rows(tr: Trainer, ids: np.ndarray) -> torch.Tensor:
    hi, lo = hashing.split_ids_t(torch.from_numpy(ids))
    pr = table_ops.probe(tr.spec, tr.shard, hi, lo, hashing.is_valid(hi, lo))
    assert bool(pr.found.all())
    return table_ops.lookup_rows(tr.shard, pr.slot).float()


def _valid(b: dict) -> np.ndarray:
    return b["ids"][np.arange(L)[None, None, :] < b["lengths"][..., None]]


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


@pytest.mark.parametrize("interaction", ["dcn", "dot"])
def test_forward_matches_the_reference(interaction):
    """The tower's forward against the plain one on the same leaves; "dot"
    is DLRM as before, against `reference/dlrm.py`."""
    name = {"dcn": "dlrm_dcnv2", "dot": "dlrm"}[interaction]
    ref = _reference(name)
    model = _model(interaction=interaction)
    leaves = _leaves(ref, model, seed=3)
    mc = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in model.items()})
    net = from_jax_params(build_model(mc), [x.numpy() for x in leaves])
    assert [tuple(p.shape[::-1]) if t else tuple(p.shape) for p, t in param_leaves(net)] == [
        s for s, _ in ref.leaf_specs(model)]
    g = torch.Generator().manual_seed(4)
    dense, emb = torch.randn((B, ND), generator=g), torch.randn((B, S, D), generator=g)
    got = net(dense, emb)
    with ref.precision("float32"):
        want = ref.forward(model, leaves, dense, emb)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_the_defaults_keep_the_dot_interaction():
    mc = ModelConfig()
    assert (mc.interaction, mc.dcn_low_rank_dim) == ("dot", 0)
    net = build_model(ModelConfig(**{**MODEL, "interaction": "dot"}))
    assert not hasattr(net, "cross_v") and hasattr(net, "_iu")
    with pytest.raises(ValueError):
        build_model(ModelConfig(**{**MODEL, "dcn_low_rank_dim": 0}))
    with pytest.raises(ValueError):
        build_model(ModelConfig(**{**MODEL, "interaction": "cat"}))


def test_three_trainer_steps_match_the_reference():
    """Losses, the first step's tower gradients (from Adam's first moment)
    and the table's rows after three steps, against the plain reference's
    steps (float64) from the same leaves and the table's own init rows."""
    ref = _reference("dlrm_dcnv2")
    model = _model()
    leaves = _leaves(ref, model, seed=5)
    tr = _trainer(model, leaves)
    batches = [_batch(s) for s in (11, 12, 13)]
    losses = [tr.train_step(batches[0])["loss"]]
    grads = [m / (1 - DENSE_OPT["b1"]) for m in tr.opt_state[0]]
    losses += [tr.train_step(b)["loss"] for b in batches[1:]]

    def start_rows(ids):
        return torch.from_numpy(ref.init_rows(ids, D, 0.01))

    out = ref.train(model, {"optimizer": OPT}, DENSE_OPT, leaves,
                    [{**b, "ids": _valid(b)} for b in batches], start_rows, "cpu")
    np.testing.assert_allclose(losses, out["losses"], rtol=1e-5)
    for (p, transposed), g, want in zip(param_leaves(tr.model), grads, out["grad1"]):
        assert _rel(g.t() if transposed else g, want) < 1e-4, p.shape
    rows = _rows(tr, out["ids"])
    start = start_rows(out["ids"])
    assert _rel(rows - start, out["change_table"]) < 1e-4
    torch.testing.assert_close(rows, (start + out["change_table"]).float(), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_ragged_and_padded_bags_train_alike(combiner):
    """The same batches with and without `lengths`: the same losses, tower
    and table rows (the padded path pools padding's zero rows)."""
    ref = _reference("dlrm_dcnv2")
    model = _model(combiner=combiner)
    leaves = _leaves(ref, model, seed=6)
    ragged, padded = _trainer(model, leaves), _trainer(model, leaves)
    for s in (21, 22):
        b = _batch(s)
        lr = ragged.train_step(b)["loss"]
        lp = padded.train_step({k: v for k, v in b.items() if k != "lengths"})["loss"]
        assert abs(lr - lp) <= 1e-6 * abs(lp)
    for p, q in zip(ragged.params, padded.params):
        torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-7)
    ids = np.unique(np.concatenate([_valid(_batch(s)) for s in (21, 22)]))
    torch.testing.assert_close(_rows(ragged, ids), _rows(padded, ids), rtol=1e-5, atol=1e-8)
    ev = ragged.eval_step(_batch(23))["logits"]
    ep = padded.eval_step({k: v for k, v in _batch(23).items() if k != "lengths"})["logits"]
    torch.testing.assert_close(ev, ep, rtol=1e-5, atol=1e-6)


def test_score_with_lengths_matches_the_reference():
    """`score(dense, ids, lengths=)`: known ids read the rows assigned,
    unknown ids zero rows, pooled by bag; against the plain reference."""
    ref = _reference("dlrm_dcnv2")
    model = _model()
    leaves = _leaves(ref, model, seed=7)
    mc = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in model.items()})
    tc = TableConfig(dim=D, capacity=1 << 12)
    tiny = TableSpec.from_config(tc)
    path = tempfile.mkdtemp(prefix="dcnv2-ckpt-")
    try:
        checkpoint.save(path, tiny, [alloc_shard(tiny, "cpu")], 0,
                        dense={"params": [x.numpy() for x in leaves]})
        svc = ScoringService(path, tc, mc, device="cpu")
    finally:
        shutil.rmtree(path, ignore_errors=True)
    ids, lengths = _bags(31)
    valid = _valid({"ids": ids, "lengths": lengths})
    uniq = np.unique(valid)
    known = uniq[np.random.default_rng(0).random(len(uniq)) < 0.8]
    rows = torch.randn((len(known), D), generator=torch.Generator().manual_seed(8))
    assert svc.table.assign(known, rows).all()
    dense = np.random.default_rng(9).standard_normal((B, ND), dtype=np.float32)
    got = svc.score(dense, ids, lengths=lengths)
    at = np.searchsorted(known, valid)
    hit = known[np.minimum(at, len(known) - 1)] == valid
    assert 0 < hit.sum() < len(valid)  # some unknown ids
    ragged_rows = torch.where(torch.from_numpy(hit)[:, None],
                              rows[torch.from_numpy(np.minimum(at, len(known) - 1))], 0.0)
    want = ref.score(model, leaves, torch.from_numpy(dense), ragged_rows, lengths)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-6)
    # without lengths the padding reads zero rows: the same scores
    np.testing.assert_allclose(svc.score(dense, ids), got, rtol=1e-5, atol=1e-6)


def test_ragged_paths_show_their_spans(tmp_path):
    """Under the profiler a ragged step and a ragged request show their own
    spans: the ids' extraction, the pooling and its backward, the cross net."""
    import json

    from torch.profiler import ProfilerActivity, profile

    ref = _reference("dlrm_dcnv2")
    model = _model()
    leaves = _leaves(ref, model, seed=9)
    tr = _trainer(model, leaves)
    tr.train_step(_batch(51))
    path = str(tmp_path / "ckpt")
    tr.save_checkpoint(path)
    svc = ScoringService(path, tr.table_cfg, tr.model_cfg, device="cpu")
    b = _batch(52)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.train_step(b)
        svc.score(b["dense"], b["ids"], lengths=b["lengths"])
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("ph") == "X"}
    for span in ("meepo.train.ragged", "meepo.table.pool", "meepo.table.pool_backward",
                 "meepo.tower.cross", "meepo.serve.ragged"):
        assert span in names, span


def test_ragged_ids_take_only_the_bags():
    ids, lengths = _bags(41)
    want = _valid({"ids": ids, "lengths": lengths})
    assert np.array_equal(pooling.ragged_ids(ids, lengths).numpy(), want)
    # one size a feature: every slot up to it, in the row-major order of [B, S]
    fixed = np.repeat(np.asarray([[3, 1, 7, 2]], np.int32), B, axis=0)
    assert np.array_equal(pooling.ragged_ids(ids, fixed).numpy(),
                          ids[np.arange(L)[None, None, :] < fixed[..., None]])
    with pytest.raises(ValueError):
        pooling.ragged_ids(ids, np.full((B, S), L + 1, np.int32))
    with pytest.raises(ValueError):
        pooling.ragged_ids(ids, lengths[:, :2])


def test_ragged_batch_takes_the_valid_ids_wherever_the_padding_lies():
    """Without `lengths` a bag's ids are its valid slots, padding first,
    last or between them; with them, its first lengths[b, s] slots."""
    ids, lengths = _bags(43)
    flat, bags = pooling.ragged_batch(ids, lengths, "cpu", "sum")
    assert np.array_equal(flat.numpy(), _valid({"ids": ids, "lengths": lengths}))
    shuffled = np.random.default_rng(3).permuted(ids, axis=2)  # padding anywhere in a bag
    got, derived = pooling.ragged_batch(torch.from_numpy(shuffled), None, "cpu", "sum")
    assert np.array_equal(got.numpy(), shuffled[shuffled != hashing.EMPTY_ID])
    assert torch.equal(derived.lengths, bags.lengths) and torch.equal(derived.of, bags.of)


def test_segment_sum_gather_plain():
    """out[sorted_rows[k]] += src[order[k]] in the order of k; rows outside
    [0, num_rows) are dropped."""
    g = torch.Generator().manual_seed(0)
    src = torch.randn((30, 6), generator=g)
    rows = torch.sort(torch.randint(-2, 12, (200,), generator=g)).values.to(torch.int32)
    order = torch.randint(0, 30, (200,), generator=g)
    got = segment_sum_gather(src, order, rows, 10)
    want = torch.zeros((10, 6), dtype=torch.float64)
    for k in range(200):
        if 0 <= rows[k] < 10:
            want[rows[k]] += src[order[k]].double()
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        segment_sum_gather(src, order.int(), rows, 10)


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("longest", [64, 300])
def test_segment_sum_gather_on_card_matches_plain(longest):
    """The segment sum reading its rows through `order` (the bag pool):
    bit-equal to the plain version where no run spans three segments,
    within the summation-order bound otherwise; the same bits twice."""
    dev = _cuda()
    g = torch.Generator().manual_seed(longest)
    n_bags, R, W = 20_000, 50_000, 128
    lens = torch.randint(0, longest + 1, (n_bags,), generator=g)
    of = torch.repeat_interleave(torch.arange(n_bags, dtype=torch.int32), lens)
    order = torch.randint(0, R, (of.shape[0],), generator=g)
    src = torch.randn((R, W), generator=g)
    plain = segment_sum_gather(src, order, of, n_bags)
    before = row_merge_add.launches
    got = segment_sum_gather(src.to(dev), order.to(dev), of.to(dev), n_bags)
    again = segment_sum_gather(src.to(dev), order.to(dev), of.to(dev), n_bags)
    torch.cuda.synchronize()
    assert row_merge_add.launches == before + 4
    assert torch.equal(got, again)
    if longest <= segment_size():
        assert torch.equal(got.cpu(), plain)
    else:
        torch.testing.assert_close(got.cpu(), plain, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_bag_pooling_on_card_matches_cpu(combiner):
    """GatherRows with ragged bags, forward and backward, on the card and
    on the CPU."""
    dev = _cuda()
    g = torch.Generator().manual_seed(1)
    U, Bb, Sb = 3000, 512, 26
    lengths = torch.randint(0, 40, (Bb, Sb), generator=g, dtype=torch.int32)
    n = int(lengths.sum())
    inv = torch.randint(0, U, (n,), generator=g, dtype=torch.int32)
    rows = torch.randn((U, 128), generator=g)
    w = torch.randn((Bb * Sb, 128), generator=g)
    out = []
    for d in ("cpu", dev):
        r = rows.detach().to(d).requires_grad_(True)
        bags = pooling.bags_on(lengths, n, d, combiner)
        pooled = dedup.GatherRows.apply(r, inv.to(d), None, None, bags)
        (pooled * w.to(d)).sum().backward()
        out.append((pooled.detach().cpu(), r.grad.cpu()))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out[1][1], out[0][1], rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_the_cross_tower_runs_without_tf32_on_card():
    """The DLRM-DCNv2 tower at its published widths leaves TF32 off and
    computes in float32: a step's forward and backward keep the flags off,
    and its output agrees with a float64 run far inside what the same tower
    gives with TF32 turned on."""
    dev = _cuda()
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    assert flags == (False, "highest")
    cfg = ModelConfig(kind="dlrm", num_dense_features=13, num_sparse_features=26,
                      embedding_dim=128, bottom_mlp=(512, 256, 128),
                      top_mlp=(1024, 1024, 512, 256, 1), interaction="dcn",
                      num_cross_layers=3, dcn_low_rank_dim=512, combiner="sum")
    net = build_model(cfg, torch.Generator().manual_seed(0)).to(dev)
    g = torch.Generator().manual_seed(1)
    dense = torch.randn((256, 13), generator=g).to(dev)
    emb = (torch.randn((256, 26, 128), generator=g) * 0.3).to(dev)
    out = net(dense, emb)
    out.sum().backward()
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision()) == flags
    wide = build_model(cfg, torch.Generator().manual_seed(0)).to(dev).double()
    with torch.no_grad():
        want = wide(dense.double(), emb.double())
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = net(dense, emb)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    assert _rel(out, want) < 1e-5
    assert _rel(tf32, want) > 10 * _rel(out, want)
