"""Each fault a cell can have, planted under the timed path of a tiny CPU
run driven by `run.py`'s own cell runners (past its look for a card), makes
`correct` come out false; the same run unbroken comes out true."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _perfbench_tiny import tiny_cell
import run
from harness import check


def _state_unchanged(mp):
    from meepoembedding_tpu_torch.ops import optim

    mp.setattr(optim, "apply_sparse_grads_ctx", lambda *a, **k: None)
    mp.setattr(optim, "dense_adam_update", lambda params, grads, state, lr, **k: state)


def _half_batch(mp):
    from meepoembedding_tpu_torch.train import Trainer

    step = Trainer.train_step
    mp.setattr(Trainer, "train_step",
               lambda self, b: step(self, {k: v[: len(v) // 2] for k, v in b.items()}))


def _loss_altered(mp):
    from meepoembedding_tpu_torch.train import Trainer

    step = Trainer.train_step
    mp.setattr(Trainer, "train_step", lambda self, b: {"loss": step(self, b)["loss"] * 1.001})


def _sparse_update_lost(mp):
    from meepoembedding_tpu_torch.ops import optim

    mp.setattr(optim, "apply_sparse_grads_ctx", lambda *a, **k: None)


def _score_altered(mp):
    from meepoembedding_tpu_torch.serving import ScoringService

    score = ScoringService.score

    def bad(self, dense, ids):
        p = score(self, dense, ids).copy()
        p[len(p) // 2] = 1.0 - p[len(p) // 2]
        return p
    mp.setattr(ScoringService, "score", bad)


def _half_scored(mp):
    from meepoembedding_tpu_torch.serving import ScoringService

    score = ScoringService.score

    def bad(self, dense, ids):
        h = max(1, len(ids) // 2)
        return np.resize(score(self, dense[:h], ids[:h]), len(ids))
    mp.setattr(ScoringService, "score", bad)


TRAIN_FAULTS = {"none": None, "state_unchanged": _state_unchanged, "half_batch": _half_batch,
                "loss_altered": _loss_altered, "sparse_update_lost": _sparse_update_lost}
SERVE_FAULTS = {"none": None, "score_altered": _score_altered, "half_scored": _half_scored}


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_train_fault(fault, monkeypatch):
    cell = tiny_cell("dlrm-kaggle.train")
    if TRAIN_FAULTS[fault]:
        TRAIN_FAULTS[fault](monkeypatch)
    res = run.run_train(cell, 11, 0.1, False, torch.device("cpu"))
    assert check.verdict(res["numbers"], cell.limits, cell.not_compared) == (fault == "none"), res["numbers"]


@pytest.mark.parametrize("fault", sorted(SERVE_FAULTS))
def test_serve_fault(fault, monkeypatch):
    cell = tiny_cell("dlrm-mlperf-tb.serve")
    if SERVE_FAULTS[fault]:
        SERVE_FAULTS[fault](monkeypatch)
    res = run.run_serve(cell, 11, 0.3, False, torch.device("cpu"))
    assert check.verdict(res["numbers"], cell.limits, cell.not_compared) == (fault == "none"), res["numbers"]
