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

Multi-hot bags, where the configuration gives `multi_hot_sizes` (one size a
feature) and `multi_hot_distribution` (`Bags`), are made as MLPerf
DLRM-DCNv2 makes them (mlcommons/training recommendation_v2/torchrec_dlrm,
`multi_hot.py` `Multihot`, `--multi_hot_distribution_type uniform`): the
example's one-hot id x of feature f, drawn as above, heads its bag, and the
other sizes[f] - 1 ids are row x of a fixed table of ids drawn uniformly
from [0, n_f), so that the same one-hot id always brings the same bag. The
source draws that table once with seed 0; here a fixed hash of (f, x, slot)
stands for it, as no [n_f, sizes[f] - 1] table fits. A bag may hold an id
twice. The ids come as [rows, S, L], L the largest size, padded with the
program's padding id, beside `lengths` [rows, S] int32. Ids outside the
vocabulary (which the source's static tables do not have) are the same
share of the valid slots, a feature's share spread evenly over its slots.
Without `multi_hot_sizes` ids are one-hot, [rows, S].
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

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


def namespaced(values: np.ndarray, feats: Optional[np.ndarray] = None) -> np.ndarray:
    """Ids of [rows, C] values, column c of feature feats[c] (default c)."""
    if feats is None:
        feats = np.arange(values.shape[1], dtype=np.int64)
    return (feats[None, :] << FEATURE_SHIFT) | values


def outside_positions(rng: np.random.Generator, cards: Sequence[float], rows: int,
                      share: float):
    """(row, column) of round(share * rows * F) positions of a [rows, F]
    batch, spread over the columns in proportion to `cards` (no position
    twice); columns come grouped, in increasing order."""
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


def _mix64(z: np.ndarray) -> np.ndarray:
    """splitmix64's finaliser of uint64 `z`: a fixed pseudo-random map."""
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


class Bags:
    """Fixed-size multi-hot bags: feature f's bag holds sizes[f] ids. A bag
    element is a column of the [rows, sum(sizes)] values, feature by
    feature; `expand` makes them from one-hot values, `pad` lays them out as
    [rows, S, L] with `pad_id` after each bag's last id."""

    DISTRIBUTIONS = ("uniform",)

    def __init__(self, sizes: Sequence[int], cards: Sequence[int], pad_id: int,
                 distribution: str = "uniform"):
        self.sizes = np.asarray(sizes, np.int64)
        if (self.sizes.ndim != 1 or len(self.sizes) == 0 or (self.sizes < 1).any()
                or (self.sizes > 4096).any()):
            raise ValueError(f"multi_hot_sizes {list(sizes)}: one size in 1..4096 a feature")
        if len(self.sizes) != len(cards):
            raise ValueError(f"{len(self.sizes)} multi_hot_sizes for {len(cards)} features")
        if distribution not in self.DISTRIBUTIONS:
            raise ValueError(f"multi_hot_distribution {distribution!r}: one of "
                             f"{self.DISTRIBUTIONS} is made")
        self.cards = np.asarray(cards, np.int64)
        self.pad_id = np.int64(pad_id)
        self.width = int(self.sizes.max())
        self.feature = np.repeat(np.arange(len(self.sizes), dtype=np.int64), self.sizes)
        self.slot = np.concatenate([np.arange(n, dtype=np.int64) for n in self.sizes])

    @classmethod
    def of(cls, cfg: dict, pad_id: int) -> Optional[Bags]:
        """The configuration's bags, or None for one-hot features."""
        sizes = cfg.get("multi_hot_sizes")
        if sizes is None:
            return None
        if "multi_hot_distribution" not in cfg:
            raise ValueError("multi_hot_sizes without multi_hot_distribution")
        return cls(sizes, cfg["cardinalities"], pad_id, cfg["multi_hot_distribution"])

    def expand(self, values: np.ndarray) -> np.ndarray:
        """[rows, S] one-hot values -> [rows, sum(sizes)]: each bag its
        one-hot value, then the fixed uniform ids of that value."""
        out = np.empty((len(values), len(self.slot)), np.int64)
        start = 0
        for f, n in enumerate(self.sizes.tolist()):
            x = values[:, f]
            out[:, start] = x
            if n > 1:  # each distinct value's row once
                u, at = np.unique(x, return_inverse=True)
                key = (u.astype(np.uint64)[:, None] << np.uint64(12)) | np.arange(
                    1, n, dtype=np.uint64)[None, :]
                key += np.uint64((f + 1) * 0x9E3779B97F4A7C15 % 2**64)
                rows = (_mix64(key) % np.uint64(self.cards[f])).astype(np.int64)
                out[:, start + 1:start + n] = rows[at.reshape(-1)]
            start += n
        return out

    def pad(self, cols: np.ndarray) -> np.ndarray:
        """[rows, sum(sizes)] ids -> [rows, S, L], padded."""
        out = np.full((len(cols), len(self.sizes), self.width), self.pad_id, np.int64)
        out[:, self.feature, self.slot] = cols
        return out

    def lengths(self, rows: int) -> np.ndarray:
        return np.repeat(self.sizes.astype(np.int32)[None, :], rows, axis=0)


def draw(rng: np.random.Generator, cards: Sequence[int], rows: int, s: float,
         bags: Optional[Bags]):
    """(ids, each column's weight for ids outside the vocabulary) of `rows`
    examples: one-hot Zipf(s) values, made into bags with `bags`,
    where a bag element weighs its feature's cardinality over its size."""
    values = zipf_values(rng, cards, rows, s)
    if bags is None:
        return namespaced(values), cards
    f = bags.feature
    return namespaced(bags.expand(values), f), np.asarray(cards, np.float64)[f] / bags.sizes[f]


def filled(lengths: np.ndarray, width: int) -> np.ndarray:
    """[..., S, width] bool: True at the slots a bag's ids take."""
    return np.arange(width) < lengths[..., None]


def valid_ids(ids: np.ndarray, lengths: Optional[np.ndarray] = None) -> np.ndarray:
    """The ids of a batch or request without padding, flat: one-hot [B, S]
    in order, or the bags' ragged ids, bag by bag in the order of [B, S]."""
    if lengths is None:
        return ids.reshape(-1)
    return ids[filled(lengths, ids.shape[2])]


@dataclasses.dataclass
class PoolBatch:
    ids: np.ndarray  # int64 [B, F] or [B, S, L] in-vocabulary ids
    dense: np.ndarray  # f32 [B, ND]
    label: np.ndarray  # f32 [B]
    fresh_at: tuple  # index of `ids` of the slots that get first sightings
    fresh_feats: np.ndarray  # their features, grouped in increasing order


class TrainFeed:
    """Closed-loop training batches: `pool_batches` batches of in-vocabulary
    ids (Zipf), dense N(0, 1) features and Bernoulli(label_rate) labels are
    made from the seed at set-up; the feed cycles through them and writes
    new first-sighting ids into each batch's fixed first-sighting positions
    on every use, so every step sees `first_sighting_share` of ids that no
    step saw before. The first `pool_batches` steps all differ. With `bags`,
    a batch also carries its `lengths`."""

    def __init__(self, cards: Sequence[int], mix: dict, num_dense: int, seed: int,
                 bags: Optional[Bags] = None):
        rng = seeds.rng(seed, "train_feed")
        B, self.cards = int(mix["batch"]), list(cards)
        self.pool: List[PoolBatch] = []
        for _ in range(int(mix["pool_batches"])):
            ids, weights = draw(rng, cards, B, float(mix["zipf_s"]), bags)
            dense = rng.standard_normal((B, num_dense), dtype=np.float32)
            label = (rng.random(B) < float(mix["label_rate"])).astype(np.float32)
            fr, fc = outside_positions(rng, weights, B, float(mix["first_sighting_share"]))
            if bags is None:
                pb = PoolBatch(ids, dense, label, (fr, fc), fc)
            else:
                ff = bags.feature[fc]
                pb = PoolBatch(bags.pad(ids), dense, label, (fr, ff, bags.slot[fc]), ff)
            self.pool.append(pb)
        self.fresh = FreshIds(cards)
        self.steps = 0
        self._unique = {}
        self.lengths = None if bags is None else bags.lengths(B)
        # lookups and bags a batch: padding is no id
        self.ids_per_batch = B * (len(cards) if bags is None else int(bags.sizes.sum()))
        self.bags_per_batch = B * len(cards)

    def next(self) -> dict:
        pb = self.pool[self.steps % len(self.pool)]
        self.steps += 1
        ids = pb.ids
        if len(pb.fresh_feats):
            ids = ids.copy()
            ids[pb.fresh_at] = (pb.fresh_feats << FEATURE_SHIFT) | self.fresh.take(pb.fresh_feats)
        batch = {"dense": pb.dense, "ids": ids, "label": pb.label}
        if self.lengths is not None:
            batch["lengths"] = self.lengths
        return batch

    def unique_per_step(self, step: int) -> int:
        """Distinct ids of step `step` (0-based): the pool batch's distinct
        in-vocabulary ids outside its first-sighting slots and its padding,
        plus one a first sighting (each is new)."""
        k = step % len(self.pool)
        if k not in self._unique:
            pb = self.pool[k]
            if self.lengths is None:
                keep = np.ones(pb.ids.shape, bool)
            else:
                keep = filled(self.lengths, pb.ids.shape[2])
            keep[pb.fresh_at] = False
            self._unique[k] = len(np.unique(pb.ids[keep])) + len(pb.fresh_feats)
        return self._unique[k]

    def fresh_per_step(self, step: int) -> int:
        return len(self.pool[step % len(self.pool)].fresh_feats)


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
    pool's ids are outside the vocabulary. With `bags`, the pool's ids are
    [P, S, L] beside `lengths` [P, S]."""

    def __init__(self, cards: Sequence[int], mix: dict, num_dense: int, seconds: float,
                 seed: int, bags: Optional[Bags] = None):
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
        self.ids, weights = draw(rng, cards, P, float(mix["zipf_s"]), bags)
        ur, uc = outside_positions(rng, weights, P, float(mix["unknown_share"]))
        uf = uc if bags is None else bags.feature[uc]
        self.ids[ur, uc] = (uf << FEATURE_SHIFT) | FreshIds(cards).take(uf)
        self.lengths = None
        if bags is not None:
            self.ids, self.lengths = bags.pad(self.ids), bags.lengths(P)
        self.dense = rng.standard_normal((P, num_dense), dtype=np.float32)
        self.lo = rng.integers(0, P - self.n + 1)

    def __len__(self) -> int:
        return len(self.n)

    def inputs(self, i: int) -> tuple:
        """(dense, ids) of request i, and with bags its lengths last."""
        lo, n = int(self.lo[i]), int(self.n[i])
        if self.lengths is None:
            return self.dense[lo:lo + n], self.ids[lo:lo + n]
        return self.dense[lo:lo + n], self.ids[lo:lo + n], self.lengths[lo:lo + n]
