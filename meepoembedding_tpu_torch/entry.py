"""Entry points for a compile check and a sharded dry run (port of the
repository root's `__graft_entry__.py`).

- `entry(device)`: the flagship forward step, DLRM-small over the dynamic
  table (the probe-only lookup and the tower), for a check on one card.
- `dryrun_multichip(n, device)`: one sharded training step of each kind
  (row-sharded dense and ragged exchange, the (row x dim) grid, a table
  group) over n ranks, then serving of the trained checkpoint, per rank and
  through one `LockstepFront`, at tiny shapes.

    python -m meepoembedding_tpu_torch.entry     # both, on the cards
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np
import torch

from meepoembedding_tpu_torch.config import ModelConfig, OptimizerConfig, RunConfig, TableConfig
from meepoembedding_tpu_torch.table.layout import resolve_device


def _cfgs(dim=32, batch=256, sparse=8, capacity=1 << 16):
    """The reference entry's configs: DLRM, 13 dense features, bottom
    64-32-dim, top 128-64-1, rowwise AdaGrad."""
    run = RunConfig(batch_size=batch, steps=1)
    table = TableConfig(dim=dim, capacity=capacity,
                        optimizer=OptimizerConfig(kind="rowwise_adagrad", learning_rate=0.05))
    model = ModelConfig(kind="dlrm", num_dense_features=13, num_sparse_features=sparse,
                        embedding_dim=dim, bottom_mlp=(64, 32, dim), top_mlp=(128, 64, 1))
    return run, table, model


def _batch(run, model, seed=0) -> dict:
    """The reference entry's global batch: feature s's ids in their own
    space (s << 44), 5,000 values a feature."""
    rng = np.random.default_rng(seed)
    b, s = run.batch_size, model.num_sparse_features
    ids = (np.arange(s, dtype=np.int64)[None, :] << 44) | rng.integers(
        0, 5000, size=(b, s), dtype=np.int64)
    return {"dense": rng.normal(size=(b, model.num_dense_features)).astype(np.float32),
            "ids": ids, "label": (rng.random(b) < 0.3).astype(np.float32)}


def entry(device="cuda"):
    """(forward, example_args): `forward(shard, model, dense, hi, lo)` ->
    [B] logits of the DLRM over an empty 2^16-slot dim-32 table, for a
    batch of 256 x 8 ids. The tower is a He-init from torch seed 0 (load
    other weights with `weights.from_jax_params`)."""
    from meepoembedding_tpu_torch.kernels import row_gather
    from meepoembedding_tpu_torch.models import build_model
    from meepoembedding_tpu_torch.models.common import model_apply
    from meepoembedding_tpu_torch.ops import dedup
    from meepoembedding_tpu_torch.table import hashing, table_ops
    from meepoembedding_tpu_torch.table.layout import TableSpec, alloc_shard

    dev = resolve_device(device)
    run, table_cfg, model_cfg = _cfgs()
    spec = TableSpec.from_config(table_cfg, num_shards=1)
    model = build_model(model_cfg, generator=torch.Generator().manual_seed(0)).to(dev).eval()
    batch = _batch(run, model_cfg)
    hi, lo = hashing.split_ids_t(torch.from_numpy(batch["ids"]).to(dev))

    def forward(shard, model, dense, hi, lo):
        b, s = hi.shape
        uniq = dedup.unique_pairs(hi.reshape(-1), lo.reshape(-1), b * s)
        rows, _ = table_ops.lookup_probe(spec, shard, uniq.hi, uniq.lo, uniq.valid)
        emb = row_gather(rows, uniq.inverse).reshape(b, s, spec.dim)
        return model_apply(model, dense, emb)

    return forward, (alloc_shard(spec, dev), model, torch.from_numpy(batch["dense"]).to(dev),
                     hi, lo)


def dryrun_multichip(n: int, device="cuda") -> None:
    """One step of each sharded trainer, and serving, over a world of n
    rank processes (`torch.multiprocessing`, spawned; they meet through a
    file store in a temporary directory). On "cuda" each rank takes one
    card over NCCL, and fewer than n visible cards raise; on "cpu" the
    ranks run over gloo. Raises if a rank fails."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"dryrun_multichip({n}) needs {n} cards, "
                           f"{torch.cuda.device_count()} are visible")
    with tempfile.TemporaryDirectory() as d:
        torch.multiprocessing.start_processes(_dryrun_rank, args=(n, d, dev.type), nprocs=n,
                                              join=True, start_method="spawn")


def _dryrun_rank(rank: int, n: int, d: str, kind: str) -> None:
    """Rank `rank` of `dryrun_multichip`'s world: every rank runs the same
    collectives in the same order, each on its rows of the global batches."""
    import torch.distributed as dist

    from meepoembedding_tpu_torch.group_train import ShardedGroupTrainer
    from meepoembedding_tpu_torch.parallel import mesh as pmesh
    from meepoembedding_tpu_torch.parallel.colsharded import ColShardedTrainer
    from meepoembedding_tpu_torch.parallel.multihost import shard_batch
    from meepoembedding_tpu_torch.parallel.trainer import ShardedTrainer
    from meepoembedding_tpu_torch.serving_sharded import LockstepFront, ShardedScoringService

    if kind == "cpu":
        torch.set_num_threads(1)
    dev = torch.device("cpu") if kind == "cpu" else torch.device("cuda", rank)
    pmesh.init_distributed("gloo" if kind == "cpu" else None, f"file://{d}/store", rank, n,
                           device=dev)
    try:
        mesh = pmesh.make_mesh(device=dev)

        def mine(batch: dict, m) -> dict:
            return {k: shard_batch(v, m) for k, v in batch.items()}

        def one_step(tr, batch: dict, what: str) -> None:
            tr.train_step(batch)
            retired = tr.flush()  # the pipelined trainers: the step's loss
            if not (retired and np.isfinite(retired[-1][1]) and len(tr) > 0):
                raise AssertionError(f"{what}: retired {retired}, {len(tr)} rows")

        # row-sharded, the dense and the ragged exchange
        run, table_cfg, model_cfg = _cfgs(dim=16, batch=16 * n, sparse=4, capacity=1 << 13)
        gb = _batch(run, model_cfg)
        tr = ShardedTrainer(run, table_cfg, model_cfg, mesh=mesh)
        one_step(tr, mine(gb, mesh), "dense exchange")
        tr_r = ShardedTrainer(dataclasses.replace(run, a2a_ragged=True), table_cfg, model_cfg,
                              mesh=mesh)
        one_step(tr_r, mine(gb, mesh), "ragged exchange")

        if n >= 2 and n % 2 == 0:  # the (row x dim) grid, (n / 2, 2)
            mesh2 = pmesh.make_mesh2d(n // 2, 2, device=dev)
            run2, table2, model2 = _cfgs(dim=16, batch=16 * (n // 2), sparse=4,
                                         capacity=1 << 13)
            tr2 = ColShardedTrainer(run2, table2, model2, mesh2, device=dev)
            one_step(tr2, mine(_batch(run2, model2), mesh2.row), "column-sharded")

        # a table group, every member row-sharded
        tables = {"user": TableConfig(dim=16, capacity=1 << 13, optimizer=OptimizerConfig(
                      kind="rowwise_adagrad", learning_rate=0.05)),
                  "item": TableConfig(dim=8, capacity=1 << 12)}
        gmodel = ModelConfig(kind="ctr_mlp", num_dense_features=4, num_sparse_features=3,
                             top_mlp=(16, 1))
        tg = ShardedGroupTrainer(run, tables, ["user", "item", "item"], gmodel, mesh=mesh,
                                 device=dev)
        rng = np.random.default_rng(7)
        b = run.batch_size
        tg.train_step(mine({"dense": rng.normal(size=(b, 4)).astype(np.float32),
                            "ids": rng.integers(0, 4000, size=(b, 3), dtype=np.int64),
                            "label": (rng.random(b) < 0.3).astype(np.float32)}, mesh))
        tg.flush()
        c = tg.counters()
        if not (np.isfinite(tg._last_loss) and c["user"]["rows"] > 0 and c["item"]["rows"] > 0):
            raise AssertionError(f"group: loss {tg._last_loss}, counters {c}")

        # serving of the trained checkpoint: each rank its rows, then one
        # global request through the front on rank 0
        ck = os.path.join(d, "ck")
        tr.save_checkpoint(ck)
        svc = ShardedScoringService(ck, table_cfg, model_cfg, mesh=mesh)
        sb = _batch(run, model_cfg, seed=3)
        p = torch.from_numpy(svc.score(*(shard_batch(sb[k], mesh).cpu().numpy()
                                         for k in ("dense", "ids"))))
        parts = [torch.empty_like(p) for _ in range(n)]
        dist.all_gather(parts, p, group=mesh.group)
        rows = svc.stats()["rows"]
        if rows != len(tr) or not torch.isfinite(p).all():
            raise AssertionError(f"serving: {rows} rows of {len(tr)}, scores {p}")
        front = LockstepFront(svc, mesh)
        if rank:
            front.follow()
            return
        got = front.score(sb["dense"], sb["ids"])
        front.stop()
        want = torch.cat(parts).numpy()
        if got.shape != (b,) or not np.allclose(got, want, rtol=1e-6, atol=1e-7):
            raise AssertionError(f"the front's scores {got} differ from the ranks' {want}")
    finally:
        pmesh.destroy()


if __name__ == "__main__":
    fn, args = entry()
    with torch.no_grad():
        print("entry logits:", fn(*args)[:4])
    n = min(8, torch.cuda.device_count())
    dryrun_multichip(n)
    print(f"dryrun_multichip({n}) ok")
