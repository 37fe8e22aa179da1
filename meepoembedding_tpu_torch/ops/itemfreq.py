"""Streaming item-frequency estimation for the sampling-bias-corrected
in-batch softmax (a copy of `meepoembedding_tpu/ops/itemfreq.py`, numpy
only; the same keys and counts bit for bit).

In-batch sampled softmax over-penalizes popular items, which appear as
negatives for almost every query. The correction (Yi et al. 2019, RecSys)
subtracts log q(item) from each candidate's logit, q being the probability
that the item appears in a batch. This module estimates q with a count-min
sketch on the host, O(B) a batch: the trainer computes the batch's log-q
vector while it assembles the inputs (`train.Trainer` with
`ModelConfig.logq_correction`).
"""

from __future__ import annotations

import numpy as np

from meepoembedding_tpu_torch.table.hashing import EMPTY_ID

_MIX = np.uint64(0x9E3779B97F4A7C15)
_SALTS = (
    np.uint64(0xC2B2AE3D27D4EB4F),
    np.uint64(0x165667B19E3779F9),
    np.uint64(0x27D4EB2F165667C5),
    np.uint64(0x9E3779B97F4A7C15),
)


def _mix64(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def item_keys_np(ids: np.ndarray, qf: int) -> np.ndarray:
    """[B, S] or [B, S, L] int64 ids -> [B] uint64 item keys over the
    item-side columns (qf..S-1), ignoring padding. It buckets the sketch;
    it need not equal `TwoTower.item_key`, which masks in-batch
    duplicates on the device."""
    ids = np.asarray(ids, np.int64)
    it = ids[:, qf:]
    h = _mix64(it.view(np.uint64))
    # a salt per feature column, so permuted features hash differently
    pos = (np.arange(it.shape[1], dtype=np.uint64) + np.uint64(1)) * _MIX
    h = _mix64(h ^ pos.reshape((1, -1) + (1,) * (it.ndim - 2)))
    h = np.where(it == EMPTY_ID, np.uint64(0), h)
    return np.bitwise_xor.reduce(h, axis=tuple(range(1, it.ndim)))


class ItemFrequencyEstimator:
    """Count-min sketch of item occurrences across batches.
    `update_and_logq(keys)` counts this batch's items, then returns
    log q_i = log(count_i / batches_seen), clipped to [log(1/batches), 0].
    A count-min sketch only overcounts, so rare items are corrected
    conservatively."""

    def __init__(self, width: int = 1 << 16, depth: int = 4):
        if width & (width - 1) or width <= 0:
            raise ValueError(f"width must be a power of two, got {width}")
        if not 1 <= depth <= len(_SALTS):
            raise ValueError(f"depth must be in 1..{len(_SALTS)}, got {depth}")
        self.width = width
        self.depth = depth
        self.counts = np.zeros((depth, width), np.int64)
        self.batches = 0

    def _slots(self, keys: np.ndarray) -> np.ndarray:
        """[B] uint64 -> [depth, B] sketch columns."""
        return np.stack([
            (_mix64(keys ^ _SALTS[d]) & np.uint64(self.width - 1)).astype(np.int64)
            for d in range(self.depth)
        ])

    def update_and_logq(self, keys: np.ndarray) -> np.ndarray:
        """Count the batch's items (each distinct item once a batch), then
        estimate log q for every row's item. Returns [B] float32."""
        keys = np.asarray(keys, np.uint64)
        uniq, inv = np.unique(keys, return_inverse=True)
        slots = self._slots(uniq)  # [depth, U]
        for d in range(self.depth):
            np.add.at(self.counts[d], slots[d], 1)
        self.batches += 1
        est = self.counts[np.arange(self.depth)[:, None], slots].min(0)  # [U]
        q = np.clip(est / self.batches, 1.0 / self.batches, 1.0)
        return np.log(q).astype(np.float32)[inv]
