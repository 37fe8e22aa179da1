"""The one generator of the traffic mixes: closed-loop training batches and
open-loop scoring requests, from a mix's parameters and a seed.

Ids: feature f's values follow the bounded Zipf(s) over its cardinality
n_f, drawn by the inverse CDF k = ((n^(1-s) - 1) u + 1)^(1/(1-s)), clipped
to n, minus one (frozen copy of `IdStream.keys` in
`meepoembedding_tpu_torch/bench/_common.py`, applied per feature). An id
is f << 44 | value, as the fill makes them.

Ids outside the vocabulary (first sightings in training, unknown ids in
scoring) take values n_f, n_f + 1, ... of their feature, which the fill
never wrote; they go to features in proportion to the features'
cardinalities, as first sightings do in a dataset whose distinct ids are
counted by feature.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from harness import seeds
from harness.fill import FEATURE_SHIFT


def zipf_values(rng: np.random.Generator, cards: Sequence[int], rows: int, s: float) -> np.ndarray:
    """[rows, F] int64 values, column f bounded Zipf(s) over [0, cards[f])."""
    n = np.asarray(cards, np.float64)[None, :]
    u = rng.random((rows, len(cards)))
    t = 1.0 - s  # inverse CDF of p(k) ~ k^-s over [1, n]
    k = ((n ** t - 1.0) * u + 1.0) ** (1.0 / t)
    return np.minimum(k.astype(np.int64), np.asarray(cards, np.int64)[None, :]) - 1


def namespaced(values: np.ndarray) -> np.ndarray:
    feat = np.arange(values.shape[1], dtype=np.int64)[None, :]
    return (feat << FEATURE_SHIFT) | values


def outside_positions(rng: np.random.Generator, cards: Sequence[int], rows: int,
                      share: float):
    """(row, feature) of round(share * rows * F) positions of a [rows, F]
    batch, spread over the features in proportion to their cardinalities
    (no position twice)."""
    F = len(cards)
    total = int(round(share * rows * F))
    if total == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    p = np.asarray(cards, np.float64) / float(np.sum(cards))
    per = np.minimum(rng.multinomial(total, p), rows)
    r = [rng.choice(rows, size=int(k), replace=False) for k in per]
    f = [np.full(int(k), j, np.int64) for j, k in enumerate(per)]
    return np.concatenate(r).astype(np.int64), np.concatenate(f)


class FreshIds:
    """Values no fill wrote: per feature n_f, n_f + 1, ... in order of use."""

    def __init__(self, cards: Sequence[int]):
        self.next = np.asarray(cards, np.int64).copy()

    def take(self, feats: np.ndarray) -> np.ndarray:
        """Values for positions of features `feats` (grouped by feature, as
        `outside_positions` gives them)."""
        counts = np.bincount(feats, minlength=len(self.next))
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = np.arange(len(feats)) - start[feats]
        vals = self.next[feats] + rank
        self.next += counts
        return vals


@dataclasses.dataclass
class PoolBatch:
    ids: np.ndarray  # int64 [B, F] in-vocabulary ids
    dense: np.ndarray  # f32 [B, ND]
    label: np.ndarray  # f32 [B]
    fresh_rows: np.ndarray  # positions that get first sightings
    fresh_feats: np.ndarray


class TrainFeed:
    """Closed-loop training batches: `pool_batches` batches of in-vocabulary
    ids (Zipf), dense N(0, 1) features and Bernoulli(label_rate) labels are
    made from the seed at set-up; the feed cycles through them and writes
    new first-sighting ids into each batch's fixed first-sighting positions
    on every use, so every step sees `first_sighting_share` of ids that no
    step saw before. The first `pool_batches` steps all differ."""

    def __init__(self, cards: Sequence[int], mix: dict, num_dense: int, seed: int):
        rng = seeds.rng(seed, "train_feed")
        B, self.cards = int(mix["batch"]), list(cards)
        self.pool: List[PoolBatch] = []
        for _ in range(int(mix["pool_batches"])):
            ids = namespaced(zipf_values(rng, cards, B, float(mix["zipf_s"])))
            dense = rng.standard_normal((B, num_dense), dtype=np.float32)
            label = (rng.random(B) < float(mix["label_rate"])).astype(np.float32)
            fr, ff = outside_positions(rng, cards, B, float(mix["first_sighting_share"]))
            self.pool.append(PoolBatch(ids, dense, label, fr, ff))
        self.fresh = FreshIds(cards)
        self.steps = 0
        self._unique = {}

    @property
    def ids_per_batch(self) -> int:
        return self.pool[0].ids.size

    def next(self) -> dict:
        pb = self.pool[self.steps % len(self.pool)]
        self.steps += 1
        ids = pb.ids
        if len(pb.fresh_rows):
            ids = ids.copy()
            ids[pb.fresh_rows, pb.fresh_feats] = ((pb.fresh_feats << FEATURE_SHIFT)
                                                 | self.fresh.take(pb.fresh_feats))
        return {"dense": pb.dense, "ids": ids, "label": pb.label}

    def unique_per_step(self, step: int) -> int:
        """Distinct ids of step `step` (0-based): the pool batch's distinct
        in-vocabulary ids outside its first-sighting positions, plus one a
        first sighting (each is new)."""
        k = step % len(self.pool)
        if k not in self._unique:
            pb = self.pool[k]
            keep = np.ones(pb.ids.shape, bool)
            keep[pb.fresh_rows, pb.fresh_feats] = False
            self._unique[k] = len(np.unique(pb.ids[keep])) + len(pb.fresh_rows)
        return self._unique[k]

    def fresh_per_step(self, step: int) -> int:
        return len(self.pool[step % len(self.pool)].fresh_rows)


SIZE_BLOCK = 256


class ServeSchedule:
    """Open-loop scoring requests: round(rate_rps * seconds) Poisson arrivals
    in the window. Request sizes come in blocks of SIZE_BLOCK, each block a
    permutation, drawn from the seed, of the same SIZE_BLOCK log-uniform
    quantiles of [candidates_min, candidates_max]: whatever the seed, the
    first k blocks hold the same sizes, so a service that works through a
    backlog scores the same candidates a second. The gaps are one set for
    every seed (the mix's own stream), in the seed's order. Request i scores
    `n[i]` consecutive candidates of a pool of `pool_candidates` rows made at
    set-up, from row `lo[i]` drawn from the seed; `unknown_share` of the
    pool's ids are outside the vocabulary."""

    def __init__(self, cards: Sequence[int], mix: dict, num_dense: int, seconds: float,
                 seed: int):
        n_req = max(1, int(round(float(mix["rate_rps"]) * seconds)))
        cmin, cmax = int(mix["candidates_min"]), int(mix["candidates_max"])
        q = (np.arange(SIZE_BLOCK) + 0.5) / SIZE_BLOCK
        block = np.minimum(np.exp(np.log(cmin) + q * np.log((cmax + 1) / cmin)).astype(np.int64),
                           cmax)
        rng = seeds.rng(seed, "serve_requests")
        blocks = -(-n_req // SIZE_BLOCK)
        self.n = np.concatenate([rng.permutation(block) for _ in range(blocks)])[:n_req]
        # n_req Poisson arrivals in the window: the n_req + 1 gaps of uniform
        # order statistics, exchangeable, so any order is as likely
        gaps = seeds.rng(0, "serve_gaps").exponential(1.0, n_req + 1)
        gaps = rng.permutation(gaps * (seconds / gaps.sum()))
        self.due = np.cumsum(gaps)[:n_req]
        P = int(mix["pool_candidates"])
        self.ids = namespaced(zipf_values(rng, cards, P, float(mix["zipf_s"])))
        ur, uf = outside_positions(rng, cards, P, float(mix["unknown_share"]))
        self.ids[ur, uf] = (uf << FEATURE_SHIFT) | FreshIds(cards).take(uf)
        self.dense = rng.standard_normal((P, num_dense), dtype=np.float32)
        self.lo = rng.integers(0, P - self.n + 1)

    def __len__(self) -> int:
        return len(self.n)

    def inputs(self, i: int):
        """(dense, ids) of request i."""
        lo, n = int(self.lo[i]), int(self.n[i])
        return self.dense[lo:lo + n], self.ids[lo:lo + n]
