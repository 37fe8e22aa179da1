"""Dict-backed reference table with the device table's semantics (port of
`meepoembedding_tpu/table/oracle.py`).

Pure Python and numpy in float64. It mirrors frequency admission, the
default row init (the same hash-derived initializer,
`hashing.default_rows`, here on CPU tensors), the rowwise and full
optimizers' math, LFU/TTL eviction, and hit/miss accounting. It ignores
capacity limits (the device table's probe-overflow drops are tested
separately).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from meepoembedding_tpu_torch.config import OptimizerConfig, PolicyConfig
from meepoembedding_tpu_torch.table import hashing


class OracleTable:
    def __init__(
        self,
        dim: int,
        initializer_scale: float = 0.01,
        optimizer: OptimizerConfig = OptimizerConfig(),
        policy: PolicyConfig = PolicyConfig(),
        init_kind: str = "uniform",
    ):
        self.dim = dim
        self.scale = initializer_scale
        self.init_kind = init_kind
        self.opt = optimizer
        self.policy = policy
        self.rows: Dict[int, np.ndarray] = {}
        self.freq: Dict[int, int] = {}
        self.last: Dict[int, int] = {}
        self.accum: Dict[int, np.ndarray] = {}  # rowwise: shape (), full: (dim,)
        self.m: Dict[int, np.ndarray] = {}
        self.seen: Dict[int, int] = {}  # admission counter
        self.hits = 0
        self.misses = 0

    # --- default init must match hashing.default_rows exactly -------------
    def _default_row(self, key: int) -> np.ndarray:
        hi, lo = hashing.split_ids(np.array([key]))
        r = hashing.default_rows(torch.from_numpy(hi), torch.from_numpy(lo), self.dim,
                                 self.scale, kind=self.init_kind)
        return r[0].numpy().astype(np.float64)

    def _admit(self, key: int) -> bool:
        self.seen[key] = self.seen.get(key, 0) + 1
        return self.seen[key] >= self.policy.admit_threshold

    def lookup(self, keys, step: int = 0, train: bool = True) -> np.ndarray:
        """find_or_insert + gather, one batch (deduped internally)."""
        out = np.zeros((len(keys), self.dim), np.float64)
        done = {}
        for i, k in enumerate(int(x) for x in keys):
            if k == int(hashing.EMPTY_ID):
                continue
            if k in done:
                out[i] = self.rows[k] if k in self.rows else 0.0
                continue
            done[k] = True
            if k in self.rows:
                self.hits += 1
                self.freq[k] += 1
                self.last[k] = step
                out[i] = self.rows[k]
            else:
                self.misses += 1
                if train and self._admit(k):
                    self.rows[k] = self._default_row(k)
                    self.freq[k] = 1
                    self.last[k] = step
                    self.accum[k] = (
                        np.float64(self.opt.initial_accumulator)
                        if self.opt.kind == "rowwise_adagrad"
                        else np.zeros(self.dim)
                    )
                    self.m[k] = np.zeros(self.dim)
                    out[i] = self.rows[k]
        # re-walk so duplicate-first occurrences see inserted rows too
        for i, k in enumerate(int(x) for x in keys):
            if k in self.rows:
                out[i] = self.rows[k]
        return out

    def apply_grads(self, keys, grads: np.ndarray):
        """Deduped-equivalent update: grads of duplicate keys are summed."""
        agg: Dict[int, np.ndarray] = {}
        for k, g in zip((int(x) for x in keys), np.asarray(grads, np.float64)):
            if k in self.rows:
                agg[k] = agg.get(k, 0) + g
        o = self.opt
        for k, g in agg.items():
            if o.kind == "sgd":
                self.rows[k] = self.rows[k] - o.learning_rate * g
            elif o.kind == "rowwise_adagrad":
                self.accum[k] = self.accum[k] + np.mean(g * g)
                self.rows[k] -= o.learning_rate / np.sqrt(self.accum[k] + o.eps) * g
            elif o.kind == "adagrad":
                self.accum[k] = self.accum[k] + g * g
                self.rows[k] -= o.learning_rate * g / np.sqrt(self.accum[k] + o.eps)
            elif o.kind == "adam":
                self.m[k] = o.beta1 * self.m[k] + (1 - o.beta1) * g
                self.accum[k] = o.beta2 * self.accum[k] + (1 - o.beta2) * g * g
                self.rows[k] -= (
                    o.learning_rate * self.m[k] / np.sqrt(self.accum[k] + o.eps * o.eps)
                )
            elif o.kind == "momentum":
                self.m[k] = o.beta1 * self.m[k] + g
                self.rows[k] = self.rows[k] - o.learning_rate * self.m[k]
            elif o.kind == "ftrl":
                # accum holds n (sum g^2), m holds z (FTRL linear state)
                n_old = self.accum[k]
                n_new = n_old + g * g
                sigma = (np.sqrt(n_new) - np.sqrt(n_old)) / o.learning_rate
                self.m[k] = self.m[k] + g - sigma * self.rows[k]
                denom = (o.ftrl_beta + np.sqrt(n_new)) / o.learning_rate + o.l2
                z = self.m[k]
                self.rows[k] = np.where(
                    np.abs(z) > o.l1, (np.sign(z) * o.l1 - z) / denom, 0.0
                )
                self.accum[k] = n_new
            else:
                raise ValueError(o.kind)

    def remove(self, keys) -> int:
        """Explicit removal; returns the number of keys actually present."""
        n = 0
        for k in set(int(x) for x in keys):
            if k in self.rows:
                n += 1
                self.rows.pop(k)
                self.freq.pop(k, None)
                self.last.pop(k, None)
                self.accum.pop(k, None)
                self.m.pop(k, None)
        return n

    def evict(self, step: int) -> Dict[int, np.ndarray]:
        pol = self.policy
        out = {}
        for k in list(self.rows):
            cold = False
            if pol.evict_policy in ("lfu", "lfu_ttl"):
                cold |= self.freq[k] < pol.lfu_min_freq
            if pol.evict_policy in ("ttl", "lfu_ttl"):
                cold |= (step - self.last[k]) > pol.ttl_steps
            if cold:
                out[k] = self.rows.pop(k)
                self.freq.pop(k)
                self.last.pop(k)
                self.accum.pop(k, None)
                self.m.pop(k, None)
        return out

    def __len__(self):
        return len(self.rows)
