"""Synthetic CTR streams: a copy of `meepoembedding_tpu/data/synthetic.py`
(numpy only), so that the port never imports the JAX package. The two give
the same batches from the same config and seed.

Generates DLRM-shaped batches with Zipf-distributed categorical ids (the
realistic regime for dynamic tables: a hot head plus an unbounded cold tail,
which exercises admission/eviction) and labels planted from a logistic model
over per-id latent weights, so a correct training loop provably lifts AUC
above 0.5.

Per-feature ids live in disjoint int64 namespaces: id = (feature << 44) | v,
matching the reference class's practice of one logical table per feature or
a namespaced shared table (README.md:2 "lookuptable-style").
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from meepoembedding_tpu_torch.table.hashing import EMPTY_ID

FEATURE_SHIFT = 44


@dataclasses.dataclass
class SyntheticConfig:
    num_dense: int = 13
    num_sparse: int = 26
    batch_size: int = 4096
    vocab_per_feature: int = 100_000
    zipf_a: float = 1.2
    seed: int = 0
    drift_per_step: int = 0  # ids shift by this much per step (streaming CTR)
    # bag_len > 1 emits multi-hot id BAGS [B, S, L] padded with the invalid
    # sentinel (0..L real ids per bag); labels plant the MEAN latent weight
    # per bag so a mean-combiner model provably learns (ops/pooling.py).
    bag_len: int = 1


class SyntheticStream:
    def __init__(self, cfg: SyntheticConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        # planted model: each id value has a latent weight via a hash;
        # label = sigmoid(sum of latent weights + dense effect) > u
        self._wkey = np.uint64(0x9E3779B97F4A7C15)

    def _latent(self, ids: np.ndarray) -> np.ndarray:
        h = ids.astype(np.uint64) * self._wkey
        h ^= h >> np.uint64(29)
        h *= np.uint64(0xBF58476D1CE4E5B9)
        h ^= h >> np.uint64(32)
        u = (h >> np.uint64(40)).astype(np.float64) / float(1 << 24)
        return (u - 0.5) * 2.0  # [-1, 1]

    def _zipf(self, n) -> np.ndarray:
        cfg = self.cfg
        z = self.rng.zipf(cfg.zipf_a, size=n).astype(np.int64)
        return z % cfg.vocab_per_feature

    def batches(self, steps: int) -> Iterator[dict]:
        cfg = self.cfg
        for step in range(steps):
            b, s, L = cfg.batch_size, cfg.num_sparse, max(1, cfg.bag_len)
            vals = self._zipf(b * s * L).reshape(b, s, L)
            if cfg.drift_per_step:
                vals = vals + np.int64(step * cfg.drift_per_step)
            feat = np.arange(s, dtype=np.int64)[None, :, None]
            ids = (feat << FEATURE_SHIFT) | vals
            dense = self.rng.normal(size=(b, cfg.num_dense)).astype(np.float32)
            if cfg.bag_len > 1:
                # variable-length bags: 0..L real ids, sentinel-padded; the
                # per-feature signal is the bag MEAN latent (mean combiner)
                cnt = self.rng.integers(0, L + 1, size=(b, s))
                mask = np.arange(L)[None, None, :] < cnt[..., None]
                lat = np.where(mask, self._latent(ids), 0.0)
                per_feat = lat.sum(-1) / np.maximum(cnt, 1)
                ids = np.where(mask, ids, EMPTY_ID)
            else:
                ids = ids[:, :, 0]
                per_feat = self._latent(ids)
            logit = (
                per_feat.sum(axis=1) * (2.0 / np.sqrt(s))
                + dense[:, 0].astype(np.float64) * 0.5
            )
            p = 1.0 / (1.0 + np.exp(-logit))
            label = (self.rng.random(b) < p).astype(np.float32)
            yield {"dense": dense, "ids": ids, "label": label}
