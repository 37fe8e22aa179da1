"""What the row-sharded layer costs a step (port of the root
`bench_sharded_overhead.py`): `ShardedTrainer` at S = 1 against the
single-device `Trainer`, on the same model (DLRM-small), table geometry,
Zipf id stream and timing method as the headline harness. At S = 1 the
sharded step pays everything a multi-device step pays but the wire
(routing, send buffers, the all-to-alls on one rank, the owner's second
dedup), so

    overhead = sharded_ms / fused_ms - 1

is the distribution machinery's cost a step, the part of multi-device
scaling that software controls.

    python -m meepoembedding_tpu_torch.bench.sharded_overhead [--device cuda|cpu]

Arms (`MEEPO_OVERHEAD_ARMS`, a comma list; default "fast,exchange,ragged"):
  fast      ShardedTrainer at S = 1 (the world-of-one fast path);
  exchange  the same with `sharded_table.FORCE_EXCHANGE`: the dense
            exchange runs on the one rank;
  ragged    the forced exchange through the ragged transport
            (`run.a2a_ragged`);
  group     a 4-table group over the same id volume (the features round
            robin onto 4 tables of cap / 4): `GroupTrainer` against
            `ShardedGroupTrainer` at S = 1.

Prints one JSON line, the reference's: {"metric":
"sharded_step_overhead_vs_fused", "devices", "ids_per_step", "fused_ms"}
and, by arm, "sharded_ms", "overhead", "route_drops";
"exchange_forced_ms", "exchange_overhead"; "exchange_ragged_ms",
"exchange_ragged_overhead"; "group_ms", "group_sharded_ms",
"group_overhead". Each arm logs its windows and its last step's loss.

A step's time is the best of 3 windows of the timed steps, whose batches
are on the device before the clock starts. The single-device trainers
read each step's loss on the host (`Trainer.train_step`); the sharded ones
read step i - depth's (`pipeline_depth` = MEEPO_BENCH_DEPTH) and retire
the rest at each window's end. The port runs one process a rank, so this
harness runs S = 1 only (the reference could put S virtual devices in one
process): a larger MEEPO_OVERHEAD_DEVICES raises.

Env knobs, the reference's: MEEPO_OVERHEAD_CAP (2^25), MEEPO_OVERHEAD_BATCH
(16384 examples), MEEPO_OVERHEAD_FEATURES (32, so 524,288 ids a step),
MEEPO_OVERHEAD_STEPS (20), MEEPO_OVERHEAD_PREFILL (40 untimed steps),
MEEPO_OVERHEAD_DEVICES (1), MEEPO_BENCH_DEPTH (2), MEEPO_OVERHEAD_ARMS.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import time

import numpy as np
import torch

from meepoembedding_tpu_torch.bench._common import (
    IdStream,
    device_kind,
    fmt_windows,
    knob,
    log,
    parse_device,
    start,
    sync,
    world,
)
from meepoembedding_tpu_torch.config import ModelConfig, OptimizerConfig, RunConfig, TableConfig
from meepoembedding_tpu_torch.group_train import GroupTrainer, ShardedGroupTrainer
from meepoembedding_tpu_torch.parallel import sharded_table as st
from meepoembedding_tpu_torch.parallel.trainer import ShardedTrainer
from meepoembedding_tpu_torch.train import Trainer


def _free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run(device="cuda", cap=None, batch=None, feats=None, steps=None, prefill=None,
        devices=None, depth=None, arms=None) -> dict:
    """The harness in this process; returns the JSON line's dict. Each
    argument left None reads the reference's environment variable."""
    cap = knob(cap, "MEEPO_OVERHEAD_CAP", 1 << 25)
    batch = knob(batch, "MEEPO_OVERHEAD_BATCH", 16384)
    feats = knob(feats, "MEEPO_OVERHEAD_FEATURES", 32)
    steps = knob(steps, "MEEPO_OVERHEAD_STEPS", 20)
    n_prefill = knob(prefill, "MEEPO_OVERHEAD_PREFILL", 40)
    S = knob(devices, "MEEPO_OVERHEAD_DEVICES", 1)
    d = knob(depth, "MEEPO_BENCH_DEPTH", 2)
    arms = set(knob(arms, "MEEPO_OVERHEAD_ARMS", "fast,exchange,ragged", str).split(","))
    if S != 1:
        raise ValueError(f"MEEPO_OVERHEAD_DEVICES={S}: the port runs one process a rank, and "
                         "this harness prices the layer at S = 1")
    dev = start(device)
    dim = 32
    ids_per_step = batch * feats
    log(f"device={device_kind(dev)} cap={cap} batch={batch} feats={feats} "
        f"({ids_per_step} ids/step) S={S}")
    run_cfg = RunConfig(batch_size=batch, steps=steps, dense_learning_rate=1e-3,
                        unique_cap=max(1024, ids_per_step // 2), pipeline_depth=d)
    table = TableConfig(dim=dim, capacity=cap, max_probe_rounds=2, insert_cap=1 << 15,
                        optimizer=OptimizerConfig(kind="rowwise_adagrad", learning_rate=0.05))
    model = ModelConfig(kind="dlrm", num_dense_features=13, num_sparse_features=feats,
                        embedding_dim=dim, bottom_mlp=(64, dim), top_mlp=(64, 1))

    # the headline's bounded Zipf(1.05) over half the capacity; the dense
    # features and labels come from the stream's generator, after its ids
    stream = IdStream(cap // 2, ids_per_step)
    rng = stream.rng

    def mk_batch() -> dict:
        return {"ids": stream.ids().reshape(batch, feats),
                "dense": rng.normal(size=(batch, 13)).astype(np.float32),
                "label": (rng.random(batch) < 0.3).astype(np.float32)}

    pre_batches = [mk_batch() for _ in range(n_prefill)]
    timed_batches = [mk_batch() for _ in range(steps)]

    def on_device():
        out = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()} for b in timed_batches]
        sync(dev)
        return out

    def windows(tr, pipelined: bool):
        """(best seconds a step, the windows, the last step's loss)."""
        dev_batches = on_device()
        ws = []
        for _ in range(3):
            t0 = time.perf_counter()
            for b in dev_batches:
                loss = tr.train_step(b)["loss"]
            if pipelined:
                loss = tr.flush()[-1][1]
            ws.append((time.perf_counter() - t0) / steps)
        return min(ws), ws, loss

    def run_fused():
        tr = Trainer(run_cfg, table, model, device=dev)
        t0 = time.perf_counter()
        for b in pre_batches:
            tr.train_step(b)  # the prefill is not timed
        log(f"fused prefill {int(tr.shard.cnt.sum())} rows in {time.perf_counter() - t0:.1f}s")
        out = windows(tr, pipelined=False)
        del tr
        _free(dev)
        return out

    def run_sharded(mesh, force_exchange=False, ragged=False):
        old = st.FORCE_EXCHANGE
        st.FORCE_EXCHANGE = force_exchange
        try:
            tr = ShardedTrainer(dataclasses.replace(run_cfg, a2a_ragged=ragged), table, model,
                                mesh=mesh)
            t0 = time.perf_counter()
            for b in pre_batches:
                tr.train_step(b)
            tr.flush()
            log(f"sharded prefill {len(tr)} rows in {time.perf_counter() - t0:.1f}s")
            best, ws, loss = windows(tr, pipelined=True)
            drops = tr.counters()["route_drops"]
        finally:
            st.FORCE_EXCHANGE = old
        del tr
        _free(dev)
        return best, ws, loss, drops

    def run_group(mesh, sharded: bool):
        """The 4-table group over the same id volume: GroupTrainer, or
        ShardedGroupTrainer at S."""
        names = [f"t{i}" for i in range(4)]
        tables = {n: TableConfig(dim=dim, capacity=cap // 4, max_probe_rounds=2,
                                 insert_cap=1 << 13,
                                 optimizer=OptimizerConfig(kind="rowwise_adagrad",
                                                           learning_rate=0.05))
                  for n in names}
        fmap = [names[i % 4] for i in range(feats)]
        gmodel = ModelConfig(kind="ctr_mlp", num_dense_features=13, num_sparse_features=feats,
                             top_mlp=(64, 1))
        tr = (ShardedGroupTrainer(run_cfg, tables, fmap, gmodel, mesh=mesh) if sharded
              else GroupTrainer(run_cfg, tables, fmap, gmodel, device=dev))
        t0 = time.perf_counter()
        for b in pre_batches:
            tr.train_step(b)
        if sharded:
            tr.flush()
        log(f"group{'-sharded' if sharded else ''} prefill in {time.perf_counter() - t0:.1f}s")
        out = windows(tr, pipelined=sharded)
        del tr
        _free(dev)
        return out

    fused_ms, fw, floss = run_fused()
    log(f"fused:            {fused_ms * 1e3:8.2f} ms/step  [{fmt_windows(fw)}]  "
        f"loss={floss!r}")
    out = {"metric": "sharded_step_overhead_vs_fused", "devices": S,
           "ids_per_step": ids_per_step, "fused_ms": round(fused_ms * 1e3, 2)}
    with world(dev) as mesh:
        if "fast" in arms:
            sharded_ms, sw, sloss, drops = run_sharded(mesh)
            log(f"sharded (S=1 fast path): {sharded_ms * 1e3:8.2f} ms/step  "
                f"[{fmt_windows(sw)}]  route_drops={drops}  loss={sloss!r}")
            out.update(sharded_ms=round(sharded_ms * 1e3, 2),
                       overhead=round(sharded_ms / fused_ms - 1.0, 4), route_drops=int(drops))
        if "exchange" in arms:
            # the exchange's own work: the routing sort, the send buffers, the
            # all-to-all, the owner's dedup and the rows' gather, without a wire
            ex_ms, ew, eloss, ex_drops = run_sharded(mesh, force_exchange=True)
            log(f"sharded (forced exchange): {ex_ms * 1e3:8.2f} ms/step  "
                f"[{fmt_windows(ew)}]  route_drops={ex_drops}  loss={eloss!r}")
            out["exchange_forced_ms"] = round(ex_ms * 1e3, 2)
            out["exchange_overhead"] = round(ex_ms / fused_ms - 1.0, 4)
        if "ragged" in arms:
            rex_ms, rew, rloss, rex_drops = run_sharded(mesh, force_exchange=True, ragged=True)
            log(f"sharded (forced RAGGED exchange): {rex_ms * 1e3:8.2f} ms/step  "
                f"[{fmt_windows(rew)}]  route_drops={rex_drops}  loss={rloss!r}")
            out["exchange_ragged_ms"] = round(rex_ms * 1e3, 2)
            out["exchange_ragged_overhead"] = round(rex_ms / fused_ms - 1.0, 4)
        if "group" in arms:
            g_ms, gw, gloss = run_group(mesh, sharded=False)
            log(f"group (4-table, single-device): {g_ms * 1e3:8.2f} ms/step  "
                f"[{fmt_windows(gw)}]  loss={gloss!r}")
            sg_ms, sgw, sgloss = run_group(mesh, sharded=True)
            log(f"group (4-table, sharded S={S}): {sg_ms * 1e3:8.2f} ms/step  "
                f"[{fmt_windows(sgw)}]  loss={sgloss!r}")
            out["group_ms"] = round(g_ms * 1e3, 2)
            out["group_sharded_ms"] = round(sg_ms * 1e3, 2)
            out["group_overhead"] = round(sg_ms / g_ms - 1.0, 4)
    return out


def main() -> None:
    print(json.dumps(run(parse_device(__doc__))), flush=True)


if __name__ == "__main__":
    main()
