"""The traffic generators from a seed: bounds per feature, the share of ids
outside the vocabulary, the request sizes, and the same data for the same
seed."""

from __future__ import annotations

import numpy as np

import _perfbench_tiny  # noqa: F401  (paths)
from harness import fill, spec, traffic

CARDS = [3, 50, 1000, 1, 20000]


def _mix(name):
    return dict(spec.load_cell(name, _perfbench_tiny.ROOT).mix)


def test_zipf_values_stay_in_each_feature_and_favour_the_head():
    rng = np.random.default_rng(0)
    v = traffic.zipf_values(rng, CARDS, 20000, 1.05)
    assert v.shape == (20000, len(CARDS))
    assert (v >= 0).all() and (v < np.asarray(CARDS)[None, :]).all()
    assert (v[:, 3] == 0).all()
    big = v[:, 4]
    assert (big == 0).mean() > (big == 100).mean() * 20  # p(k) ~ k^-1.05


def test_train_feed_first_sightings():
    mix = {**_mix("dlrm-kaggle.train"), "batch": 512, "pool_batches": 3}
    feed = traffic.TrainFeed(CARDS, mix, 13, seed=5)
    seen = set()
    share = mix["first_sighting_share"]
    for step in range(7):
        b = feed.next()
        ids = b["ids"]
        assert ids.shape == (512, len(CARDS)) and b["dense"].shape == (512, 13)
        pos = fill.positions_of_ids(ids.reshape(-1), CARDS)
        outside = ids.reshape(-1)[pos < 0]
        assert len(outside) == round(share * ids.size) == feed.fresh_per_step(step)
        assert not (set(outside.tolist()) & seen)  # never seen before
        seen |= set(outside.tolist())
        assert (outside >> fill.FEATURE_SHIFT < len(CARDS)).all()
        assert feed.unique_per_step(step) == len(np.unique(ids))
    assert set(np.unique(b["label"]).tolist()) <= {0.0, 1.0}


def test_train_feed_without_first_sightings_repeats_its_pool():
    mix = {**_mix("dlrm-mlperf-tb.train"), "batch": 64, "pool_batches": 2}
    feed = traffic.TrainFeed(CARDS, mix, 13, seed=5)
    a, b, c = feed.next(), feed.next(), feed.next()
    assert (fill.positions_of_ids(a["ids"].reshape(-1), CARDS) >= 0).all()
    assert not np.array_equal(a["ids"], b["ids"]) and np.array_equal(a["ids"], c["ids"])


def test_one_seed_gives_the_same_data():
    mix = {**_mix("dlrm-kaggle.train"), "batch": 128, "pool_batches": 2}
    x = [traffic.TrainFeed(CARDS, mix, 13, seed=s).next() for s in (9, 9, 10)]
    assert all(np.array_equal(x[0][k], x[1][k]) for k in x[0])
    assert not np.array_equal(x[0]["ids"], x[2]["ids"])
    smix = {**_mix("dlrm-kaggle.serve"), "rate_rps": 200.0, "pool_candidates": 4096}
    s = [traffic.ServeSchedule(CARDS, smix, 13, 5.0, seed=q) for q in (3, 3, 4)]
    assert np.array_equal(s[0].ids, s[1].ids)
    assert np.array_equal(s[0].due, s[1].due) and np.array_equal(s[0].lo, s[1].lo)
    assert not np.array_equal(s[0].n, s[2].n)


def test_serve_schedule_sizes_arrivals_and_unknown_ids():
    smix = {**_mix("dlrm-kaggle.serve"), "rate_rps": 400.0, "pool_candidates": 8192}
    s = traffic.ServeSchedule(CARDS, smix, 13, 10.0, seed=1)
    n, due = s.n, s.due
    lo, hi = smix["candidates_min"], smix["candidates_max"]
    assert n.min() >= lo and n.max() <= hi
    # log-uniform: log n is uniform, so its mean sits mid-way
    assert abs(np.log(n).mean() - (np.log(lo) + np.log(hi)) / 2) < 0.02
    assert due[0] > 0.0 and (np.diff(due) >= 0).all() and due[-1] < 10.0
    assert len(s) == len(due) == 4000
    other = traffic.ServeSchedule(CARDS, smix, 13, 10.0, seed=2)
    # every block of SIZE_BLOCK requests holds the same sizes for every
    # seed, in another order; the gaps are one set, in another order
    B = traffic.SIZE_BLOCK
    for k in range(0, 4000 - B + 1, B):
        assert sorted(n[k:k + B].tolist()) == sorted(other.n[k:k + B].tolist())
    assert not np.array_equal(n, other.n)
    gaps = np.diff(np.concatenate([[0.0], due, [10.0]]))
    other_gaps = np.diff(np.concatenate([[0.0], other.due, [10.0]]))
    assert np.allclose(sorted(gaps), sorted(other_gaps))
    pos = fill.positions_of_ids(s.ids.reshape(-1), CARDS)
    assert (pos < 0).mean() == round(smix["unknown_share"] * s.ids.size) / s.ids.size
    d, ids = s.inputs(3)
    assert d.shape == (n[3], 13) and ids.shape == (n[3], len(CARDS))
    assert np.array_equal(ids, s.ids[s.lo[3]:s.lo[3] + n[3]])
