"""Multi-hot bags declared by a configuration's `multi_hot_sizes` and
`multi_hot_distribution`: they are made as MLPerf DLRM-DCNv2 makes them,
the feed and the schedule lay them out as the port takes them and count valid ids
only, the reference pools the ragged rows as padded bags would, a tiny CPU
rehearsal of DLRM with DLRM-DCNv2's bags comes out correct and its planted
faults do not, and a stand-in reference module of another port kind gives
the tower's leaves and the FLOPs with no harness edit."""

from __future__ import annotations

import math
import sys
import types

import numpy as np
import pytest
import torch

import _perfbench_tiny
from _perfbench_tiny import DCNV2_SIZES, bag_cell, tiny_cell
import run
from harness import check, fill, program, spec, traffic, train_cell, weights, work
from reference import dlrm

CARDS = [max(1, 3 + 17 * j) for j in range(len(DCNV2_SIZES))]
PAD = program.PAD_ID


def _mix(name, **over):
    return {**spec.load_cell(name, _perfbench_tiny.ROOT).mix, **over}


def _check_bags(ids, lengths, rows):
    assert ids.shape == (rows, len(DCNV2_SIZES), max(DCNV2_SIZES)) and ids.dtype == np.int64
    assert lengths.dtype == np.int32 and (lengths == np.asarray(DCNV2_SIZES)[None, :]).all()
    inside = traffic.filled(lengths, ids.shape[2])
    assert (ids[~inside] == PAD).all()
    valid = traffic.valid_ids(ids, lengths)
    assert len(valid) == rows * sum(DCNV2_SIZES) == rows * 214
    # every valid id in its own feature's namespace
    feat = np.broadcast_to(np.arange(ids.shape[1])[None, :, None], ids.shape)
    assert np.array_equal(valid >> fill.FEATURE_SHIFT, feat[inside])
    return valid


def test_train_feed_of_bags():
    mix = _mix("dlrm-kaggle.train", batch=64, pool_batches=2)
    bags = traffic.Bags(DCNV2_SIZES, CARDS, PAD)
    feed = traffic.TrainFeed(CARDS, mix, 13, 5, bags)
    assert feed.ids_per_batch == 64 * 214 and feed.bags_per_batch == 64 * 26
    seen = set()
    for step in range(4):
        b = feed.next()
        valid = _check_bags(b["ids"], b["lengths"], 64)
        pos = fill.positions_of_ids(valid, CARDS)
        outside = valid[pos < 0]
        # first sightings: a share of the valid slots, never seen before
        assert len(outside) == round(mix["first_sighting_share"] * 64 * 214)
        assert len(outside) == feed.fresh_per_step(step) > 0
        assert not set(outside.tolist()) & seen
        seen |= set(outside.tolist())
        assert feed.unique_per_step(step) == len(np.unique(valid))
    # the same seed gives the same batches
    again = traffic.TrainFeed(CARDS, mix, 13, 5, bags)
    x, y = feed.pool[0], again.pool[0]
    assert np.array_equal(x.ids, y.ids) and np.array_equal(x.dense, y.dense)


def test_serve_schedule_of_bags():
    mix = _mix("dlrm-kaggle.serve", rate_rps=200.0, pool_candidates=2048)
    s = traffic.ServeSchedule(CARDS, mix, 13, 2.0, 7, traffic.Bags(DCNV2_SIZES, CARDS, PAD))
    valid = _check_bags(s.ids, s.lengths, 2048)
    assert (fill.positions_of_ids(valid, CARDS) < 0).sum() == round(
        mix["unknown_share"] * 2048 * 214)
    dense, ids, lengths = s.inputs(3)
    lo, n = s.lo[3], s.n[3]
    assert dense.shape == (n, 13) and np.array_equal(ids, s.ids[lo:lo + n])
    assert np.array_equal(lengths, s.lengths[lo:lo + n])


def test_bags_expand_as_the_source_makes_them():
    """torchrec_dlrm's `Multihot` (uniform): a bag is its one-hot id, then a
    fixed row of ids drawn uniformly from the feature's cardinality."""
    cards = [1000] * len(DCNV2_SIZES)
    bags = traffic.Bags(DCNV2_SIZES, cards, PAD)
    values = np.random.default_rng(3).integers(0, 1000, (2000, len(DCNV2_SIZES)))
    f = DCNV2_SIZES.index(100)
    values[:1000, f] = np.arange(1000)
    values[1001] = values[1000]
    cols = bags.expand(values)
    assert cols.shape == (2000, 214) and cols.dtype == np.int64
    heads = np.cumsum([0] + DCNV2_SIZES[:-1])
    assert np.array_equal(cols[:, heads], values)
    # the same one-hot id always brings the same bag, and the map is fixed
    assert np.array_equal(cols[1000], cols[1001])
    assert np.array_equal(cols, traffic.Bags(DCNV2_SIZES, cards, PAD).expand(values))
    # the rest of a bag: uniform over [0, n), different for each one-hot id
    rest = cols[:1000, heads[f] + 1:heads[f] + 100]
    assert rest.min() >= 0 and rest.max() < 1000
    hist = np.bincount(rest.ravel(), minlength=1000)
    assert hist.mean() == 99 and hist.std() < 1.5 * 99 ** 0.5
    assert len(np.unique(rest[2])) > 90 and not np.array_equal(rest[2], rest[3])


def test_bags_are_refused_unless_declared_whole():
    with pytest.raises(ValueError):
        traffic.Bags.of({"multi_hot_sizes": [1, 2], "multi_hot_distribution": "uniform",
                         "cardinalities": [5, 5, 5]}, PAD)
    with pytest.raises(ValueError):
        traffic.Bags.of({"multi_hot_sizes": [1, 2], "cardinalities": [5, 5]}, PAD)
    with pytest.raises(ValueError):
        traffic.Bags([1, 2], [5, 5], PAD, "pareto")
    with pytest.raises(ValueError):
        traffic.Bags([2, 0, 1], [5, 5, 5], PAD)
    assert traffic.Bags.of({"cardinalities": [5]}, PAD) is None


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_reference_pools_ragged_rows_as_padded_bags(combiner):
    g = torch.Generator().manual_seed(0)
    lengths = torch.tensor([[3, 0, 1], [2, 5, 1]], dtype=torch.int32)
    L, D = 5, 4
    padded = torch.randn((2, 3, L, D), generator=g, dtype=torch.float64)
    mask = torch.arange(L)[None, None, :] < lengths[..., None]
    padded = padded * mask[..., None]
    want = padded.sum(dim=2)
    cnt = lengths.clamp(min=1).to(torch.float64)[..., None]
    want = {"sum": want, "mean": want / cnt, "sqrtn": want / cnt.sqrt()}[combiner]
    got = dlrm.pool(padded[mask], lengths.numpy(), combiner)
    assert got.shape == (2, 3, D) and torch.allclose(got, want, rtol=1e-12, atol=0)


def _mean_pooling(mp):
    from meepoembedding_tpu_torch.ops import pooling

    pool = pooling.pool_bags
    mp.setattr(pooling, "pool_bags", lambda emb, valid, combiner: pool(emb, valid, "mean"))


def _lose_an_element(ids):
    """The last id of the first example's largest bag set to padding."""
    ids = np.array(ids, copy=True)
    f = DCNV2_SIZES.index(max(DCNV2_SIZES))
    ids[0, f, max(DCNV2_SIZES) - 1] = PAD
    return ids


def _element_lost(mp):
    from meepoembedding_tpu_torch.serving import ScoringService
    from meepoembedding_tpu_torch.train import Trainer

    step, score = Trainer.train_step, ScoringService.score
    mp.setattr(Trainer, "train_step",
               lambda self, b: step(self, {**b, "ids": _lose_an_element(b["ids"])}))
    mp.setattr(ScoringService, "score",
               lambda self, dense, ids: score(self, dense, _lose_an_element(ids)))


FAULTS = {"none": None, "mean_pooling": _mean_pooling, "element_lost": _element_lost}


@pytest.mark.parametrize("loop", ["train", "serve"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_bag_rehearsal_and_faults(loop, fault, monkeypatch):
    cell = bag_cell(f"dlrm-mlperf-tb.{loop}")
    if FAULTS[fault]:
        FAULTS[fault](monkeypatch)
    if loop == "train":
        res = run.run_train(cell, 13, 0.1, False, torch.device("cpu"))
    else:
        res = run.run_serve(cell, 13, 0.3, False, torch.device("cpu"))
        assert res["attempted"] > 0
    assert res["failed"] == 0
    ok = check.verdict(res["numbers"], cell.limits, cell.not_compared)
    assert ok == (fault == "none"), res["numbers"]


def test_a_score_that_takes_lengths_gets_them(monkeypatch, capsys):
    """A port whose `score` takes `lengths` gets each request's, in the warm-up
    and in the window; the run says so."""
    from meepoembedding_tpu_torch.serving import ScoringService

    score, seen = ScoringService.score, []

    def score_with_lengths(self, dense, ids, lengths):
        seen.append((ids, lengths))
        return score(self, dense, ids)

    monkeypatch.setattr(ScoringService, "score", score_with_lengths)
    cell = bag_cell("dlrm-mlperf-tb.serve")
    res = run.run_serve(cell, 17, 0.3, False, torch.device("cpu"))
    assert "with their lengths" in capsys.readouterr().err
    assert check.verdict(res["numbers"], cell.limits, cell.not_compared)
    warm = 2 * len({int(x) for x in np.geomspace(cell.mix["candidates_min"],
                                                 cell.mix["candidates_max"], 12)})
    assert res["attempted"] > 0 and len(seen) >= warm + res["attempted"]
    for ids, lengths in seen:
        assert lengths is not None and lengths.dtype == np.int32
        assert lengths.shape == ids.shape[:2] and (lengths == np.asarray(DCNV2_SIZES)).all()


def test_train_feed_counts_lookups_not_padding():
    cell = bag_cell("dlrm-mlperf-tb.train")
    tc = train_cell.TrainCell(cell, 3, "cpu")
    w = tc.window(0.05)
    assert tc.feed.ids_per_batch == cell.mix["batch"] * 214
    assert w["ids"] == w["steps"] * cell.mix["batch"] * 214


# A stand-in reference module for the port's `dcn` kind (models/dcn.py):
# cross layers [I, I] and [I] over x0 = [dense | pooled embeddings], a deep
# MLP over x0 with ReLU after every layer, a linear head over both.
def _dcn_parts(model):
    i = model["num_dense_features"] + model["num_sparse_features"] * model["embedding_dim"]
    deep = list(model["top_mlp"][:-1]) or [64]
    mlp, d = [], i
    for h in deep:
        mlp.append((d, h))
        d = h
    return i, model["num_cross_layers"], mlp, (i + deep[-1], 1)


def _dcn_leaf_specs(model):
    i, n, mlp, head = _dcn_parts(model)
    out = [((i, i), (1.0 / i) ** 0.5), ((i,), 0.01)] * n
    for a, b in mlp + [head]:
        out += [((a, b), (2.0 / a) ** 0.5), ((b,), 0.01)]
    return out


def _dcn_macs(model):
    i, n, mlp, head = _dcn_parts(model)
    return n * i * i + sum(a * b for a, b in mlp + [head])


def test_a_stand_in_reference_of_another_kind_draws_leaves_and_counts_macs(monkeypatch):
    from meepoembedding_tpu_torch.models import build_model
    from meepoembedding_tpu_torch.weights import from_jax_params, to_jax_params

    mod = types.ModuleType("reference.standin_dcn")
    mod.leaf_specs, mod.macs_per_example, mod.init_rows = (_dcn_leaf_specs, _dcn_macs,
                                                           dlrm.init_rows)
    monkeypatch.setitem(sys.modules, "reference.standin_dcn", mod)
    cell = tiny_cell("dlrm-kaggle.train")
    cfg = cell.config
    cfg["reference"] = "benchmark/reference/standin_dcn.py"
    cfg["model"] = {"kind": "dcn", "num_dense_features": 13, "num_sparse_features": 26,
                    "embedding_dim": 16, "top_mlp": [32, 1], "num_cross_layers": 2,
                    "combiner": "sum", "dtype": "float32"}
    cfg["multi_hot_sizes"] = list(DCNV2_SIZES)
    cfg["multi_hot_distribution"] = "uniform"
    assert spec.reference(cfg) is mod

    leaves = weights.tower_leaves(cfg, 4, "cpu")
    specs = _dcn_leaf_specs(cfg["model"])
    assert [tuple(x.shape) for x in leaves] == [s for s, _ in specs]
    assert torch.equal(leaves[0], weights.tower_leaves(cfg, 4, "cpu")[0])
    assert abs(float(leaves[0].std()) * math.sqrt(429) - 1.0) < 0.01  # I = 13 + 26 * 16
    # by hand: 2 cross layers of 429^2, the deep layer 429 x 32, the head 461 x 1
    assert work.train_flops_per_example(cfg) == 6 * (2 * 429 * 429 + 429 * 32 + 461)

    # the port takes the configuration and the leaves as they are, and trains
    mc = program.model_config(cfg)
    assert (mc.kind, mc.num_cross_layers, mc.combiner) == ("dcn", 2, "sum")
    model = from_jax_params(build_model(mc), [x.numpy() for x in leaves])
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(to_jax_params(model), leaves))
    tc = train_cell.TrainCell(cell, 4, "cpu")
    assert type(tc.trainer.model).__name__ == "DCNv2"
    prog = tc.first_steps()
    assert all(np.isfinite(prog["losses"])) and tc.failed == 0
    assert tc.window(0.05)["ids"] % (cell.mix["batch"] * 214) == 0
