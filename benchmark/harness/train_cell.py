"""The closed-loop training cell: `Trainer.train_step` on a filled dynamic
table, fed as fast as it steps.

Set-up builds one `Trainer`, loads the tower's weights made from the seed,
fills the table with the configuration's vocabulary, and drives the first
`REF_STEPS` steps through the window's own call and feed, reading the
program's state around them; the same trainer then runs the window. After
the window the reference follows those first steps from the same inputs.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from harness import check, fill, program
from harness.spec import reference
from harness.traffic import Bags, TrainFeed, valid_ids
from harness.weights import tower_leaves

REF_STEPS = 3
WARM_STEPS = 5


def quarters(done_s: np.ndarray, seconds: float) -> list:
    """Steps completed in each quarter of the window: a drift shows here."""
    edges = np.linspace(0.0, seconds, 5)
    return np.histogram(np.minimum(done_s, seconds), bins=edges)[0].tolist()


def _norms(ts) -> List[float]:
    return [float(torch.linalg.vector_norm(t.double())) for t in ts]


def start_rows(cfg: dict, seed: int, device):
    """The reference's rows of ids before any step: the fill's row for a
    vocabulary id, the table's initializer for a first sighting."""
    cards, dim = cfg["cardinalities"], cfg["model"]["embedding_dim"]
    t, ref = cfg["table"], reference(cfg)

    def rows(ids: np.ndarray) -> torch.Tensor:
        pos = fill.positions_of_ids(ids, cards)
        out = torch.from_numpy(ref.init_rows(ids, dim, t["initializer_scale"])).to(device)
        known = pos >= 0
        at = torch.from_numpy(np.nonzero(known)[0]).to(device)
        out[at] = fill.rows_at(pos[known], cards, dim, cfg["fill"]["row_scale"], seed, device)
        return out
    return rows


class TrainCell:
    def __init__(self, cell, seed: int, device):
        from meepoembedding_tpu_torch.table.runtime import DynamicEmbeddingTable
        from meepoembedding_tpu_torch.train import Trainer
        from meepoembedding_tpu_torch.weights import from_jax_params

        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        cfg, mix = cell.config, cell.mix
        self.cfg = cfg
        batch = int(mix["batch"])
        self.trainer = Trainer(program.run_config(cfg, batch), program.table_config(cfg),
                               program.model_config(cfg), device=self.device)
        self.leaves0 = tower_leaves(cfg, seed, self.device)
        from_jax_params(self.trainer.model, [x.cpu().numpy() for x in self.leaves0])
        table = DynamicEmbeddingTable(program.table_config(cfg), device=self.device,
                                      shard=self.trainer.shard)
        self.vocab = int(sum(cfg["cardinalities"]))
        self.landed = fill.fill(lambda ids, rows: int(table.assign(ids, rows).sum()),
                                cfg["cardinalities"], cfg["model"]["embedding_dim"],
                                cfg["fill"]["row_scale"], seed, self.device)
        self.feed = TrainFeed(cfg["cardinalities"], mix, cfg["model"]["num_dense_features"],
                              seed, Bags.of(cfg, program.PAD_ID))
        self.failed = 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self, batch) -> float:
        loss = self.trainer.train_step(batch)["loss"]
        if not np.isfinite(loss):
            self.failed += 1
        return loss

    def first_steps(self) -> dict:
        """Run the first REF_STEPS steps; the program's readings of them."""
        tr, spec = self.trainer, self.trainer.spec
        opt = self.cfg["table"]["optimizer"]
        batches = [self.feed.next() for _ in range(REF_STEPS)]
        valid = [valid_ids(b["ids"], b.get("lengths")) for b in batches]
        all_ids = np.unique(np.concatenate(valid))
        ids1 = np.unique(valid[0])
        w0, _, found0 = program.read_rows(spec, tr.shard, all_ids)
        init = torch.from_numpy(reference(self.cfg).init_rows(all_ids, spec.dim,
                                              self.cfg["table"]["initializer_scale"]))
        w0 = torch.where(found0[:, None], w0, init.to(w0.device))
        at1 = torch.from_numpy(np.searchsorted(all_ids, ids1)).to(w0.device)
        losses = [self.step(batches[0])]
        b1 = float(self.cfg["dense_optimizer"]["b1"])
        grad_dense = [m / (1.0 - b1) for m in tr.opt_state[0]]
        w1, a1, _ = program.read_rows(spec, tr.shard, ids1)
        g_table = (w0[at1] - w1) * torch.sqrt(a1 + opt["eps"])[:, None] / opt["learning_rate"]
        grad = _norms(grad_dense) + _norms([g_table])
        losses += [self.step(b) for b in batches[1:]]
        w3, _, _ = program.read_rows(spec, tr.shard, all_ids)
        p0 = [x.t() if x.dim() == 2 else x for x in self.leaves0]
        change = _norms([p.detach() - q for p, q in zip(tr.params, p0)]) + _norms([w3 - w0])
        c = tr.counters()
        self.batches = batches
        return {"losses": losses, "grad": grad, "change": change,
                "dropped": (self.vocab - self.landed) + c["drops"] + c["denied"]}

    def warm(self, n: int = WARM_STEPS) -> None:
        for _ in range(n):
            self.step(self.feed.next())
        self._sync()

    def window(self, seconds: float) -> dict:
        self._sync()
        t0 = time.perf_counter()
        end, n = t0 + seconds, 0
        first = self.feed.steps
        done = []
        while True:
            self.step(self.feed.next())
            n += 1
            done.append(time.perf_counter())
            if done[-1] >= end:
                break
        self._sync()
        t1 = time.perf_counter()
        return {"steps": n, "seconds": t1 - t0, "ids": n * self.feed.ids_per_batch,
                "first_step": first, "quarters": quarters(np.asarray(done) - t0, seconds)}

    def free(self) -> None:
        self.trainer = None


def reference_readings(cfg: dict, seed: int, batches, device, kind: str = "float32") -> dict:
    """The reference's readings of the same steps, in `kind` precision; a
    batch of bags goes to it as its ragged ids and lengths."""
    leaves = tower_leaves(cfg, seed, device)
    batches = [{**b, "ids": valid_ids(b["ids"], b["lengths"])} if "lengths" in b else b
               for b in batches]
    out = reference(cfg).train(cfg["model"], cfg["table"], cfg["dense_optimizer"], leaves, batches,
                    start_rows(cfg, seed, device), device, kind=kind)
    return {"losses": out["losses"],
            "grad": _norms(out["grad1"]) + _norms([out["grad1_table"]]),
            "change": _norms(out["change"]) + _norms([out["change_table"]])}


def moving(refr: dict) -> list:
    """Leaves whose first gradient in the reference is more than rounding:
    at least a thousandth of the median leaf's."""
    med = float(np.median(refr["grad"]))
    return [g >= 1e-3 * med for g in refr["grad"]]


def compare(prog: dict, refr: dict) -> dict:
    """The numbers `correct` is decided by (PERF.md, section 4):

      loss_gap        the widest relative gap of a step's loss
      grad_gap        the first gradient's norm, by the worst tower leaf
      table_grad_gap  the same of the table's rows, apart: read back from
                      the stored rows, it carries their rounding
      change_gap      the parameters' change after the steps, by the
                      median leaf that moves
      table_change_gap  the table rows' change after the steps, by its own
                      norm: 1 when the rows' update is lost or doubled
      dropped_ids     vocabulary ids the fill or the steps failed to place
    """
    g = check.leaf_gaps(prog["grad"], refr["grad"])
    return {
        "loss_gap": max(check.rel_gap(a, b) for a, b in zip(prog["losses"], refr["losses"])),
        "grad_gap": float(g[:-1].max()),
        "table_grad_gap": float(g[-1]),
        "change_gap": check.median_leaf(prog["change"], refr["change"], moving(refr)),
        "table_change_gap": check.rel_gap(prog["change"][-1], refr["change"][-1]),
        "dropped_ids": float(prog.get("dropped", 0)),
    }


def leaf_detail(prog: dict, refr: dict) -> dict:
    """Per-leaf gaps (dense leaves in the reference's order, the table
    last), for the look behind a number."""
    keep = moving(refr)
    return {"grad": check.leaf_gaps(prog["grad"], refr["grad"]).tolist(),
            "change": check.leaf_gaps(prog["change"], refr["change"], keep).tolist(),
            "change_worst": check.worst_leaf(prog["change"], refr["change"], keep),
            "ref_grad": list(refr["grad"]), "ref_change": list(refr["change"])}
