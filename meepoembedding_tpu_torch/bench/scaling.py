"""Weak scaling of the row-sharded trainer (port of the root
`bench_scaling.py`): a fixed batch a rank, so that

    efficiency(S) = examples_per_sec(S) / (S * examples_per_sec(1)).

    python -m meepoembedding_tpu_torch.bench.scaling [--device cuda|cpu]

The reference built each mesh of S devices in one process; the port runs
one process a rank, so for each S this spawns S rank processes
(`torch.multiprocessing`, a file store in a temporary directory). Each
rank trains `ShardedTrainer` on its `per_device_batch` rows of the global
SyntheticStream batch (DLRM, dim 16, 2^20 slots, rowwise AdaGrad): 2
untimed steps, then `steps` timed ones, the last retired by `flush()`
before its clock stops. Rank 0 gathers the ranks' times; a world's rate
is its global examples over the slowest rank's time. Rank 0's kernel
launches are logged (`S=<S>: rank 0 launches {...}`).

On "cuda" each rank takes one card over NCCL, and an S larger than the
visible cards raises: two ranks never share a card. On "cpu" the ranks
run gloo worlds, one torch thread each; like the reference's CPU mesh,
those numbers check the harness, not scaling (the ranks share the host's
cores).

Prints one JSON line, the reference's: {"metric":
"weak_scaling_examples_per_sec", "platform", "per_device_batch", "rates":
{S: examples/s}, "efficiency": {S: ...}}; "platform" is "gpu" or "cpu".

Env knobs, the reference's: MEEPO_SCALE_DEVICES (world sizes, "1,2,4,8";
the reference dropped those above its device count, the port raises on
"cuda", so one card takes MEEPO_SCALE_DEVICES=1), MEEPO_SCALE_BATCH (1024
examples a rank), MEEPO_SCALE_STEPS (10).
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import torch
import torch.distributed as dist

from meepoembedding_tpu_torch.bench._common import knob, log, parse_device, start
from meepoembedding_tpu_torch.config import ModelConfig, OptimizerConfig, RunConfig, TableConfig
from meepoembedding_tpu_torch.data.synthetic import SyntheticConfig, SyntheticStream
from meepoembedding_tpu_torch.kernels import (
    row_gather,
    row_merge_add,
    row_scatter_add,
    row_scatter_set,
)
from meepoembedding_tpu_torch.parallel import mesh as pmesh
from meepoembedding_tpu_torch.parallel.multihost import shard_batch
from meepoembedding_tpu_torch.parallel.trainer import ShardedTrainer


def _configs(S: int, per_dev_batch: int, steps: int):
    dim = 16
    batch = per_dev_batch * S
    run = RunConfig(batch_size=batch, steps=steps, dense_learning_rate=1e-3)
    table = TableConfig(dim=dim, capacity=1 << 20,
                        optimizer=OptimizerConfig(kind="rowwise_adagrad", learning_rate=0.05))
    model = ModelConfig(kind="dlrm", num_dense_features=13, num_sparse_features=26,
                        embedding_dim=dim, bottom_mlp=(64, dim), top_mlp=(64, 1))
    data = SyntheticConfig(num_dense=13, num_sparse=26, batch_size=batch,
                           vocab_per_feature=50000)
    return run, table, model, data


def rank_main(rank: int, S: int, d: str, kind: str, per_dev_batch: int, steps: int) -> None:
    """Rank `rank` of a world of S: its timed steps; rank 0 writes the
    slowest rank's seconds and its own kernel launches (this process's,
    every step's) to `d`/rank0.json."""
    if kind == "cpu":
        torch.set_num_threads(1)
    dev = torch.device("cpu") if kind == "cpu" else torch.device("cuda", rank)
    pmesh.init_distributed("gloo" if kind == "cpu" else None, f"file://{d}/store", rank, S,
                           device=dev)
    try:
        mesh = pmesh.make_mesh(device=dev)
        run, table, model, data = _configs(S, per_dev_batch, steps)
        tr = ShardedTrainer(run, table, model, mesh=mesh)
        mine = [{k: shard_batch(v, mesh) for k, v in b.items()}
                for b in SyntheticStream(data).batches(steps + 2)]
        tr.train_step(mine[0])  # warm-up
        tr.train_step(mine[1])
        t0 = time.perf_counter()
        for b in mine[2:]:
            # pipelined: the trainer reads step i - depth's loss itself
            tr.train_step(b)
        tr.flush()  # the last steps in flight, before the clock stops
        dt = torch.tensor([time.perf_counter() - t0], dtype=torch.float64, device=dev)
        if S > 1:
            dist.all_reduce(dt, op=dist.ReduceOp.MAX)
        if rank == 0:
            kernels = (row_gather, row_scatter_set, row_scatter_add, row_merge_add)
            with open(os.path.join(d, "rank0.json"), "w") as f:
                json.dump({"seconds": float(dt.item()),
                           "launches": {k.__name__: k.launches for k in kernels}}, f)
    finally:
        pmesh.destroy()


def run(device="cuda", devices=None, batch=None, steps=None) -> dict:
    """The harness, its worlds in rank processes; returns the JSON line's
    dict. Each argument left None reads the reference's environment
    variable."""
    sizes = [int(s) for s in knob(devices, "MEEPO_SCALE_DEVICES", "1,2,4,8", str).split(",")]
    per_dev_batch = knob(batch, "MEEPO_SCALE_BATCH", 1024)
    steps = knob(steps, "MEEPO_SCALE_STEPS", 10)
    dev = start(device)
    if dev.type == "cuda" and max(sizes) > torch.cuda.device_count():
        raise ValueError(f"MEEPO_SCALE_DEVICES={','.join(map(str, sizes))}: a world of "
                         f"{max(sizes)} needs as many cards, {torch.cuda.device_count()} "
                         "are visible (two ranks never share a card)")
    rates = {}
    for S in sizes:
        with tempfile.TemporaryDirectory() as d:
            torch.multiprocessing.start_processes(
                rank_main, args=(S, d, dev.type, per_dev_batch, steps), nprocs=S, join=True,
                start_method="spawn")
            with open(os.path.join(d, "rank0.json")) as f:
                rank0 = json.load(f)
        dt = rank0["seconds"]
        rates[S] = per_dev_batch * S * steps / dt
        log(f"S={S}: {rates[S]:.0f} examples/s ({dt / steps * 1e3:.1f} ms/step)")
        log(f"S={S}: rank 0 launches {json.dumps(rank0['launches'])}")
    base = rates.get(1)
    return {
        "metric": "weak_scaling_examples_per_sec",
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "per_device_batch": per_dev_batch,
        "rates": {str(k): round(v, 1) for k, v in rates.items()},
        "efficiency": {str(k): round(v / (k * base), 4) for k, v in rates.items()}
        if base else {},
    }


def main() -> None:
    print(json.dumps(run(parse_device(__doc__))), flush=True)


if __name__ == "__main__":
    main()
