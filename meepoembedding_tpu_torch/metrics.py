"""Training metrics and logs (port of `meepoembedding_tpu/metrics.py:21-96`).

- StreamingAUC: fixed-bin histogram rank-sum AUC. The histograms live on
  the device of the logits (f64, exact for integer counts) and reach the
  host only in `compute`, so an update costs no host sync.
- Meter: running mean and last value of a scalar.
- JsonlLogger: one JSON object per line, to a file and/or stdout.
"""

from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np
import torch


class StreamingAUC:
    def __init__(self, num_bins: int = 8192):
        self.num_bins = num_bins
        self.pos: Optional[torch.Tensor] = None
        self.neg: Optional[torch.Tensor] = None

    def update(self, logits, labels) -> None:
        logits = torch.as_tensor(logits)
        labels = torch.as_tensor(labels, device=logits.device)
        p = torch.sigmoid(logits.reshape(-1).to(torch.float32))
        idx = torch.clamp((p * self.num_bins).to(torch.int64), 0, self.num_bins - 1)
        y = labels.reshape(-1).to(torch.float64)
        if self.pos is None or self.pos.device != logits.device:
            self.pos = torch.zeros(self.num_bins, dtype=torch.float64, device=logits.device)
            self.neg = torch.zeros_like(self.pos)
        self.pos.index_add_(0, idx, y)
        self.neg.index_add_(0, idx, 1.0 - y)

    def compute(self) -> float:
        """AUC = P(score_pos > score_neg) + 0.5 P(equal), from the histograms."""
        if self.pos is None:
            return 0.5
        pos, neg = self.pos.cpu().numpy(), self.neg.cpu().numpy()
        npos, nneg = pos.sum(), neg.sum()
        if npos == 0 or nneg == 0:
            return 0.5
        cum_neg = np.cumsum(neg) - neg  # negatives strictly below the bin
        wins = np.sum(pos * cum_neg)
        ties = np.sum(pos * neg) * 0.5
        return float((wins + ties) / (npos * nneg))

    def reset(self) -> None:
        self.pos = self.neg = None


class Meter:
    """Running mean + last value."""

    def __init__(self):
        self.sum = 0.0
        self.n = 0
        self.last = 0.0

    def update(self, v: float) -> None:
        v = float(v)
        self.sum += v
        self.n += 1
        self.last = v

    @property
    def mean(self) -> float:
        return self.sum / max(1, self.n)


class JsonlLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._fh = open(path, "a") if path else None

    def log(self, **kv) -> None:
        kv.setdefault("t", time.time())
        line = json.dumps(kv, default=float)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.echo:
            print(line, flush=True)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
