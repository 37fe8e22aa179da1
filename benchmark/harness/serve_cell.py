"""The open-loop scoring cell: `ScoringService.score` on a filled table,
requests arriving on a Poisson schedule far above what the service
sustains, so that a backlog builds at once and the service scores back to
back; the window counts the candidates scored.

Set-up writes a checkpoint of the tower's weights and a few rows into the
temporary directory, builds the service from it, fills the table with
`assign`, makes the schedule and the candidate pool, and scores each size
class once. One thread sends the requests in order, each at its due time or
as soon as the one before it has been answered: the service serialises
requests on its lock, so a second sender would only queue there. At the
window's close no further request starts; the backlog left is logged.
"""

from __future__ import annotations

import contextlib
import inspect
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from harness import fill, program, seeds, spec
from harness.traffic import Bags, ServeSchedule, valid_ids
from harness.weights import tower_leaves

SAMPLE_REQUESTS = 48


class ServeCell:
    def __init__(self, cell, seed: int, device, seconds: float):
        from meepoembedding_tpu_torch import checkpoint
        from meepoembedding_tpu_torch.serving import ScoringService
        from meepoembedding_tpu_torch.table import hashing, table_ops
        from meepoembedding_tpu_torch.table.layout import TableSpec, alloc_shard

        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        cfg = self.cfg = cell.config
        tc, mc = program.table_config(cfg), program.model_config(cfg)
        dim = cfg["model"]["embedding_dim"]
        leaves = [x.cpu().numpy() for x in tower_leaves(cfg, seed, self.device)]
        # a checkpoint of the tower and 4 rows; the fill overwrites the rows
        tiny = TableSpec.from_config(program.table_config({**cfg, "table": {
            **cfg["table"], "capacity": 1024}}))
        shard = alloc_shard(tiny, "cpu")
        ids = torch.arange(4, dtype=torch.int64)
        hi, lo = hashing.split_ids_t(ids)
        table_ops.insert_rows(tiny, shard, hi, lo, torch.zeros((4, dim)),
                              torch.ones(4, dtype=torch.bool), 0)
        path = tempfile.mkdtemp(prefix="bench-ckpt-", dir=os.environ.get("TMPDIR"))
        try:
            checkpoint.save(path, tiny, [shard], 0, dense={"params": leaves})
            self.svc = ScoringService(path, tc, mc, device=self.device)
        finally:
            shutil.rmtree(path, ignore_errors=True)
        # bags go to `score` padded, and their lengths too where it takes a
        # parameter `lengths`, as the feed names them
        self.takes_lengths = "lengths" in inspect.signature(self.svc.score).parameters
        if "multi_hot_sizes" in cfg:
            print(f"serve: bags go to score padded, "
                  f"{'with' if self.takes_lengths else 'without'} their lengths",
                  file=sys.stderr, flush=True)
        self.vocab = int(sum(cfg["cardinalities"]))
        self.landed = fill.fill(lambda i, r: int(self.svc.table.assign(i, r).sum()),
                                cfg["cardinalities"], dim, cfg["fill"]["row_scale"], seed,
                                self.device)
        self.sched = ServeSchedule(cfg["cardinalities"], cell.mix,
                                   cfg["model"]["num_dense_features"], seconds, seed,
                                   Bags.of(cfg, program.PAD_ID))
        self.warm()

    def warm(self) -> None:
        lo, hi = self.cell.mix["candidates_min"], self.cell.mix["candidates_max"]
        sizes = sorted({int(x) for x in np.geomspace(lo, hi, 12)})
        s = self.sched
        for n in sizes:
            for _ in range(2):
                self.score(s.dense[:n], s.ids[:n], None if s.lengths is None else s.lengths[:n])

    def score(self, dense, ids, lengths=None):
        """The service's scores of one request's inputs."""
        if lengths is not None and self.takes_lengths:
            return self.svc.score(dense, ids, lengths=lengths)
        return self.svc.score(dense, ids)

    def window(self, seconds: float, annotate=None) -> dict:
        """Serve the requests in order, each at its due time or when the one
        before it is answered, until the window closes; `done_s` is each
        answer's time from the window's start (inf: not started or
        failed). `annotate(name)`, if given, wraps the waits and the calls
        in host ranges."""
        s, ann = self.sched, annotate or (lambda name: contextlib.nullcontext())
        done = np.full(len(s), np.inf)
        self.outputs, failed, started = {}, 0, 0
        t0 = time.perf_counter()
        close = t0 + seconds
        for i in range(len(s)):
            wait = t0 + s.due[i] - time.perf_counter()
            if wait > 0:
                with ann("bench.wait_for_due"):
                    time.sleep(wait)
            if time.perf_counter() >= close:
                break
            started += 1
            try:
                with ann("bench.serve"):
                    p = self.score(*s.inputs(i))
            except Exception as e:  # a failed request is counted, not fatal
                if not failed:
                    print(f"request {i} failed: {e!r}", file=sys.stderr, flush=True)
                failed += 1
                continue
            done[i] = time.perf_counter() - t0
            self.outputs[i] = p
        due = int(np.searchsorted(s.due, seconds, side="right"))
        return {"done_s": done, "started": started, "answered": len(self.outputs),
                "failed": failed, "backlog": due - started, "seconds": seconds,
                "candidates_in_window": int(s.n[done <= seconds].sum())}

    def free(self) -> None:
        self.svc = None

    def sample(self) -> list:
        """Answered requests to check, drawn from the seed, with the largest."""
        done = sorted(self.outputs)
        if not done:
            return []
        rng = seeds.rng(self.seed, "serve_sample")
        pick = set(rng.choice(done, size=min(SAMPLE_REQUESTS, len(done)), replace=False).tolist())
        pick.add(max(done, key=lambda i: self.sched.n[i]))
        return sorted(pick)

    def answers(self) -> tuple:
        """The sampled requests' scores and inputs, and the vocabulary ids
        that the fill or the table failed to place."""
        pick = self.sample()
        dropped = self.vocab - self.landed + self.svc.table.counters()["drops"]
        return [self.outputs[i] for i in pick], [self.sched.inputs(i) for i in pick], dropped


def reference_scores(cfg: dict, seed: int, inputs, device, kind: str = "float32") -> list:
    """The reference's scores of each request's inputs (dense, ids[,
    lengths]): the fill's rows for vocabulary ids, zero rows for unknown
    ones; a request of bags goes to it as its ragged rows and lengths."""
    cards, dim = cfg["cardinalities"], cfg["model"]["embedding_dim"]
    leaves = tower_leaves(cfg, seed, device)
    all_ids = np.unique(np.concatenate([valid_ids(*req[1:]) for req in inputs]))
    pos = fill.positions_of_ids(all_ids, cards)
    rows = torch.zeros((len(all_ids), dim), device=device)
    known = pos >= 0
    rows[torch.from_numpy(np.nonzero(known)[0]).to(device)] = fill.rows_at(
        pos[known], cards, dim, cfg["fill"]["row_scale"], seed, device)
    ref, out = spec.reference(cfg), []
    with ref.precision(kind):
        for dense, ids, *lengths in inputs:
            at = torch.from_numpy(np.searchsorted(all_ids, valid_ids(ids, *lengths))).to(device)
            emb = rows[at] if lengths else rows[at].view(ids.shape[0], ids.shape[1], dim)
            out.append(ref.score(cfg["model"], leaves, torch.as_tensor(dense, device=device),
                                 emb, *lengths).cpu().numpy())
    return out


def compare(prog: list, refr: list, unanswered: int, dropped: int) -> dict:
    """score_gap: the widest |p - p_ref| of a sampled request's score;
    unanswered: started requests that failed; dropped_ids: as `answers`."""
    gap = max((float(np.max(np.abs(p.astype(np.float64) - r))) for p, r in zip(prog, refr)),
              default=np.inf)
    return {"score_gap": gap, "unanswered": float(unanswered), "dropped_ids": float(dropped)}
