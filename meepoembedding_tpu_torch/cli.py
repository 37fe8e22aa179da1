"""Command-line entry points of the port (port of `meepoembedding_tpu/cli.py`):
`train`, `eval`, `serve`, `bench-lookup`, `bench-update`, `ckpt-inspect`,
`ckpt-export`, `ckpt-import` behind one argparse front end, with the
reference's flags and its stdout/stderr JSON lines.

Config layering: frozen-dataclass defaults <- YAML file (--config) <- dotted
overrides (`--set table.capacity=1048576 run.steps=200`). PyYAML is imported
only when --config is given.

Every subcommand takes `--device {cuda,cpu}` (default cuda, which raises
without a card; cpu runs the kernels' plain PyTorch versions):

  python -m meepoembedding_tpu_torch train --data synthetic --set run.steps=100
  python -m meepoembedding_tpu_torch eval --ckpt /path/to/ckpt --data holdout.tsv
  python -m meepoembedding_tpu_torch serve --ckpt /path/to/ckpt --http 8080
  python -m meepoembedding_tpu_torch bench-lookup --rows 1e8 --batch 524288
  python -m meepoembedding_tpu_torch ckpt-export /path/to/ckpt --out emb.npz
  torchrun --nproc-per-node 4 -m meepoembedding_tpu_torch train --distributed ...

`--distributed` runs one process a rank (`parallel/`): the ranks meet
through torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT), each reads its own `batch_size / S` rows of every global
batch (the synthetic stream at seed + rank, Criteo lines i % S == rank),
and only rank 0 prints. A world of one takes the single-device path, as the
reference does on one device. `train --distributed --col-shards C` lays a
world of S * C ranks out as an S x C grid (`parallel/colsharded.py`): the C
ranks of a row shard read the same rows and hold its column blocks. A
`tables:` group config with --distributed row-shards every member
(`group_train.ShardedGroupTrainer`) for train, serve and eval.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time
import typing
from typing import Optional, Tuple

import numpy as np
import torch

from meepoembedding_tpu_torch.config import (
    ModelConfig,
    OptimizerConfig,
    RunConfig,
    TableConfig,
)
from meepoembedding_tpu_torch.table.layout import resolve_device


# --- config layering -------------------------------------------------------------

def _coerce(value: str, field_type):
    if field_type in (int, "int"):
        return int(float(value))  # allow 1e6
    if field_type in (float, "float"):
        return float(value)
    if field_type in (bool, "bool"):
        return value.lower() in ("1", "true", "yes")
    origin = typing.get_origin(field_type)
    if origin in (tuple, list):
        inner = typing.get_args(field_type)[0]
        return tuple(_coerce(v, inner) for v in value.split(",") if v != "")
    if origin is typing.Union:  # Optional[...]
        args = [a for a in typing.get_args(field_type) if a is not type(None)]
        if value.lower() in ("none", "null", ""):
            return None
        return _coerce(value, args[0])
    return value


def _apply_overrides(cfg, overrides: dict):
    """Apply {dotted.path: value} onto a frozen dataclass, returning a copy."""
    direct = {}
    nested: dict = {}
    for k, v in overrides.items():
        head, _, rest = k.partition(".")
        if rest:
            nested.setdefault(head, {})[rest] = v
        else:
            direct[head] = v
    fields = {f.name: f for f in dataclasses.fields(cfg)}
    hints = typing.get_type_hints(type(cfg))  # resolves string annotations
    updates = {}
    for k, v in direct.items():
        if k not in fields:
            raise KeyError(f"{type(cfg).__name__} has no field '{k}'")
        if isinstance(v, str):
            v = _coerce(v, hints.get(k, str))
        elif isinstance(v, list):  # YAML sequences -> tuple fields
            v = tuple(v)
        updates[k] = v
    for k, sub in nested.items():
        if k not in fields:
            raise KeyError(f"{type(cfg).__name__} has no field '{k}'")
        updates[k] = _apply_overrides(getattr(cfg, k), sub)
    return dataclasses.replace(cfg, **updates)


def _read_yaml(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def load_configs(config_path: Optional[str] = None, sets: Optional[list] = None) -> tuple:
    """-> (RunConfig, TableConfig, ModelConfig) from defaults + YAML + --set."""
    layers = {"run": {}, "table": {}, "model": {}}
    if config_path:
        doc = _read_yaml(config_path)
        for section in layers:
            for k, v in (doc.get(section) or {}).items():
                layers[section][k] = v
    for item in sets or []:
        k, eq, v = item.partition("=")
        if not eq:
            raise ValueError(f"--set expects key=value, got '{item}'")
        section, _, rest = k.partition(".")
        if section not in layers:
            raise KeyError(f"--set section must be run/table/model, got '{section}'")
        layers[section][rest] = v
    return (
        _build_cfg(RunConfig, layers["run"]),
        _build_cfg(TableConfig, layers["table"]),
        _build_cfg(ModelConfig, layers["model"]),
    )


def _build_cfg(cls, d: dict):
    """Nested field dict -> frozen config dataclass (the run/table/model
    sections and the per-table entries of a `tables:` group config)."""
    flat = {}

    def flatten(prefix, dd):
        for k, v in dd.items():
            if isinstance(v, dict):
                flatten(f"{prefix}{k}.", v)
            else:
                flat[f"{prefix}{k}"] = v

    flatten("", d)
    return _apply_overrides(cls(), flat)


def load_group_configs(config_path: Optional[str], sets: Optional[list] = None):
    """Heterogeneous multi-table config (group_train.GroupTrainer).

    Returns (run_cfg, {name: TableConfig}, feature_map, model_cfg) when the
    YAML carries a `tables:` section, else None:

        tables:
          user: {dim: 64, capacity: 4194304, optimizer: {kind: rowwise_adagrad}}
          item: {dim: 32, capacity: 1048576}
        feature_map: [user, item, item]   # sparse column -> table
        run: {...}   model: {...}         # the normal sections

    `--set run.* / model.*` apply as usual; `--set table.*` (the
    single-table section) is refused rather than ignored."""
    if not config_path:
        return None
    doc = _read_yaml(config_path)
    if "tables" not in doc:
        return None
    if any(item.partition("=")[0].startswith("table.") for item in sets or []):
        raise SystemExit("--set table.* does not apply to a `tables:` group config; "
                         "set per-table fields in the YAML")
    feature_map = doc.get("feature_map")
    if not feature_map:
        raise SystemExit("`tables:` config needs a `feature_map:` list")
    run_cfg, _, model_cfg = load_configs(config_path, sets)
    tables = {name: _build_cfg(TableConfig, dict(spec or {}))
              for name, spec in doc["tables"].items()}
    if model_cfg.num_sparse_features != len(feature_map):
        model_cfg = dataclasses.replace(model_cfg, num_sparse_features=len(feature_map))
    return run_cfg, tables, list(feature_map), model_cfg


# --- spill tiers ---------------------------------------------------------------

def _default_spill_path() -> str:
    """The disk log of --spill disk without --spill-path: meepo_spill.log in
    the temporary directory (TMPDIR, else /tmp)."""
    return os.path.join(tempfile.gettempdir(), "meepo_spill.log")


def _make_spill(args, table_cfg, rank: Optional[int] = None):
    """The cold-tier backend of --spill. `rank` (a rank of a world of more
    than one) gives each rank its own disk log."""
    if not getattr(args, "spill", None) or args.spill == "none":
        return None
    from meepoembedding_tpu_torch.backends import make_backend
    from meepoembedding_tpu_torch.table.layout import TableSpec
    from meepoembedding_tpu_torch.tiering import SpillCodec

    kwargs = {}
    if args.spill == "disk":
        kwargs["path"] = args.spill_path or _default_spill_path()
        if rank is not None:
            kwargs["path"] += f".rank{rank}"
    if args.spill == "redis":
        kwargs["host"], _, port = (args.spill_addr or "127.0.0.1:6379").partition(":")
        kwargs["port"] = int(port or 6379)
    width = SpillCodec(TableSpec.from_config(table_cfg)).width
    return make_backend(args.spill, width=width, **kwargs)


def _make_group_spill(args, tables: dict, rank: Optional[int] = None):
    """A spill backend a member of a `tables:` group, host or disk only: one
    redis keyspace cannot hold the members' different row widths. `rank`
    (a rank of a world of more than one) gives each rank its own disk logs."""
    if not getattr(args, "spill", None) or args.spill == "none":
        return None
    if args.spill == "redis":
        raise SystemExit("`tables:` group training supports --spill host|disk (one redis "
                         "keyspace cannot hold several tables' different row widths)")
    from meepoembedding_tpu_torch.backends import make_backend
    from meepoembedding_tpu_torch.table.layout import TableSpec
    from meepoembedding_tpu_torch.tiering import SpillCodec

    out = {}
    for name, cfg in tables.items():
        kwargs = {}
        if args.spill == "disk":
            kwargs["path"] = f"{args.spill_path or _default_spill_path()}.{name}"
            if rank is not None:
                kwargs["path"] += f".rank{rank}"
        width = SpillCodec(TableSpec.from_config(cfg)).width
        out[name] = make_backend(args.spill, width=width, **kwargs)
    return out


# --- data ----------------------------------------------------------------------

def _expand_paths(data: str):
    """Comma-separated paths with glob support (--data 'day_*.gz'), sorted
    within each pattern; a pattern that matches nothing raises."""
    import glob as _glob

    out = []
    for p in data.split(","):
        if any(ch in p for ch in "*?["):
            hits = sorted(_glob.glob(p))
            if not hits:
                raise ValueError(f"--data pattern matched no files: {p}")
            out.extend(hits)
        else:
            out.append(p)
    return out


def make_train_stream(data: str, run_cfg, model_cfg, host_id: int, num_hosts: int,
                      bag_len: int = 1):
    """Each of `num_hosts` readers gets a disjoint slice of the input: Criteo
    lines i % num_hosts == host_id (looping, parsed on a prefetch thread),
    or the synthetic stream at seed + host_id. Batches of
    `run_cfg.batch_size` rows."""
    if data == "synthetic":
        from meepoembedding_tpu_torch.data import SyntheticConfig, SyntheticStream

        return SyntheticStream(SyntheticConfig(
            batch_size=run_cfg.batch_size,
            num_sparse=model_cfg.num_sparse_features,
            num_dense=model_cfg.num_dense_features,
            seed=run_cfg.seed + host_id,
            bag_len=bag_len,
        ))
    from meepoembedding_tpu_torch.data import CriteoStream, PrefetchStream

    return PrefetchStream(CriteoStream(
        _expand_paths(data), batch_size=run_cfg.batch_size, loop=True,
        host_id=host_id, num_hosts=num_hosts,
    ))


# --- the world of a --distributed run ----------------------------------------------

def _world() -> Tuple[int, int, int]:
    """(rank, world size, local rank) from torchrun's environment; (0, 1, 0)
    outside it."""
    env = os.environ
    rank = int(env.get("RANK", "0"))
    return rank, int(env.get("WORLD_SIZE", "1")), int(env.get("LOCAL_RANK", str(rank)))


def _sharded(args) -> bool:
    """--distributed over a world of more than one rank."""
    return bool(getattr(args, "distributed", False)) and _world()[1] > 1


@contextlib.contextmanager
def _joined_world(args):
    """The mesh of torchrun's world on this rank's device (card LOCAL_RANK,
    or the CPU over gloo). A process group this call starts is left at
    exit, so that one process can run several commands."""
    import torch.distributed as dist

    from meepoembedding_tpu_torch.parallel import mesh as pmesh

    rank, world, local = _world()
    dev = torch.device("cpu") if args.device == "cpu" else torch.device("cuda", local)
    joined = not dist.is_initialized()
    pmesh.init_distributed(init_method="env://" if world > 1 else None, rank=rank,
                           world_size=world, device=dev)
    try:
        yield pmesh.make_mesh(device=dev)
    finally:
        if joined:
            pmesh.destroy()


def _rank_run_cfg(run_cfg, S: int):
    """The run config of one rank's stream: its `batch_size / S` rows."""
    if run_cfg.batch_size % S:
        raise ValueError(f"run.batch_size {run_cfg.batch_size} does not split over {S} ranks")
    return dataclasses.replace(run_cfg, batch_size=run_cfg.batch_size // S)


def _gather(t, mesh) -> np.ndarray:
    """Every rank's rows of `t` (the same shape on each), rank after rank,
    on the host of every rank."""
    import torch.distributed as dist

    t = torch.as_tensor(t).detach().cpu().contiguous()
    if mesh.size == 1:
        return t.numpy()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts).numpy()


def _global_auc(auc, mesh) -> float:
    """A rank's StreamingAUC merged over the world: its histograms summed
    (exact, in f64). Every rank calls it at the same step."""
    import torch.distributed as dist

    from meepoembedding_tpu_torch.metrics import StreamingAUC

    if mesh.size == 1 or auc.pos is None:  # the ranks retire steps in lockstep
        return auc.compute()
    both = torch.stack([auc.pos, auc.neg]).cpu()
    dist.all_reduce(both, group=mesh.group)
    merged = StreamingAUC(auc.num_bins)
    merged.pos, merged.neg = both[0], both[1]
    return merged.compute()


def _lockstep(batches, mesh):
    """The batches while every rank has one: a rank's single pass over its
    lines can be a batch longer than another's, and a sharded step is a
    collective."""
    import torch.distributed as dist

    it = iter(batches)
    while True:
        b = next(it, None)
        have = torch.tensor([0 if b is None else 1], dtype=torch.int32)
        if mesh.size > 1:
            dist.all_reduce(have, op=dist.ReduceOp.MIN, group=mesh.group)
        if not int(have):
            return
        yield b


@contextlib.contextmanager
def _profiled(run_cfg, dev):
    """run.profile_dir: a torch.profiler trace of the block, written there
    as trace-rank<r>.json (also when the block fails)."""
    if not run_cfg.profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    prof = profile(activities=acts)
    try:
        with prof:
            yield
    finally:
        os.makedirs(run_cfg.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(run_cfg.profile_dir,
                                              f"trace-rank{_world()[0]}.json"))


# --- train ---------------------------------------------------------------------

def _train_group(args, run_cfg, tables, feature_map, model_cfg, mesh=None) -> int:
    """Heterogeneous multi-table training behind the same `train` front end,
    selected by a `tables:` YAML section: on one device, or with `mesh` (a
    world of S > 1) a ShardedGroupTrainer fed this rank's rows, rank 0
    printing. --spill host|disk gives every member its own backend (a rank
    its own); --maintenance-every runs each member's eviction tick."""
    from meepoembedding_tpu_torch.group_train import GroupTrainer, ShardedGroupTrainer
    from meepoembedding_tpu_torch.metrics import JsonlLogger, Meter

    S, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    spill = _make_group_spill(args, tables, rank if mesh is not None else None)
    stream = make_train_stream(args.data, _rank_run_cfg(run_cfg, S), model_cfg, rank, S,
                               bag_len=args.bag_len)
    if mesh is None:
        tr = GroupTrainer(run_cfg, tables, feature_map, model_cfg, spill=spill,
                          device=args.device)
    else:
        tr = ShardedGroupTrainer(run_cfg, tables, feature_map, model_cfg, mesh=mesh,
                                 spill=spill)
    if args.restore:
        tr.load_checkpoint(args.restore)
    logger = JsonlLogger(echo=rank == 0)
    loss_m = Meter()
    t0 = time.perf_counter()
    examples = 0
    for i, batch in enumerate(stream.batches(run_cfg.steps)):
        out = tr.train_step(batch)
        if out["loss"] is not None:  # the sharded trainer lags pipeline_depth steps
            loss_m.update(out["loss"])
        examples += len(batch["label"]) * S
        if (i + 1) % run_cfg.log_every == 0:
            auc = tr.auc.compute() if mesh is None else _global_auc(tr.auc, mesh)
            logger.log(step=tr.step, loss=loss_m.mean, auc=auc,
                       examples_per_sec=examples / (time.perf_counter() - t0),
                       rows={n: c["rows"] for n, c in tr.counters().items()})
        if args.maintenance_every and (i + 1) % args.maintenance_every == 0:
            tr.maintenance()
        if args.ckpt_dir and args.ckpt_every and (i + 1) % args.ckpt_every == 0:
            tr.save_checkpoint(args.ckpt_dir)
    if mesh is not None:
        for _s, loss in tr.flush():
            loss_m.update(loss)
    if args.ckpt_dir:
        tr.save_checkpoint(args.ckpt_dir)
    auc = tr.auc.compute() if mesh is None else _global_auc(tr.auc, mesh)
    if rank == 0:
        print(json.dumps({"final_auc": auc, "steps": tr.step}))
    return 0


def _train_sharded(args, run_cfg, table_cfg, model_cfg, mesh, mesh2d=None) -> None:
    """`train --distributed` on this rank of a world of more than one: a
    ShardedTrainer fed this rank's rows, or (--col-shards C) a
    ColShardedTrainer on the S x C grid `mesh2d`, whose row mesh `mesh`
    is: the C ranks of a row shard read the same rows, its column-0 rank
    holds the cold tier, and the metrics come from column 0's ranks. World
    rank 0 prints."""
    from meepoembedding_tpu_torch.metrics import JsonlLogger, Meter, StreamingAUC
    from meepoembedding_tpu_torch.parallel.colsharded import ColShardedTrainer
    from meepoembedding_tpu_torch.parallel.trainer import ShardedTrainer

    S, rank = mesh.size, mesh.rank
    if mesh2d is None and run_cfg.mesh_shape and int(np.prod(run_cfg.mesh_shape)) != S:
        raise ValueError(f"run.mesh_shape={run_cfg.mesh_shape} needs a world of "
                         f"{int(np.prod(run_cfg.mesh_shape))} ranks; torchrun started {S}")
    rank_cfg = _rank_run_cfg(run_cfg, S)
    stream = make_train_stream(args.data, rank_cfg, model_cfg, rank, S, bag_len=args.bag_len)
    if mesh2d is None:
        lead = rank == 0
        tr = ShardedTrainer(run_cfg, table_cfg, model_cfg, mesh=mesh,
                            spill=_make_spill(args, table_cfg, rank))
    else:
        lead = mesh2d.world.rank == 0
        spill = (_make_spill(args, table_cfg, mesh2d.world.rank) if mesh2d.col.rank == 0
                 else None)
        tr = ColShardedTrainer(run_cfg, table_cfg, model_cfg, mesh2d, spill=spill)
    if args.restore:
        tr.load_checkpoint(args.restore)
    # each column's row mesh merges its own metrics: column 0's reach rank 0
    logger = JsonlLogger(echo=lead)
    loss_m = Meter()
    t0 = time.perf_counter()
    examples = 0
    eval_iter = None
    if run_cfg.eval_every:  # held-out stream, decorrelated seed
        eval_iter = make_train_stream(
            args.data, dataclasses.replace(rank_cfg, seed=run_cfg.seed + 7919), model_cfg,
            rank, S, bag_len=args.bag_len).batches(run_cfg.steps)
    for i, batch in enumerate(stream.batches(run_cfg.steps)):
        out = tr.train_step(batch)
        # pipelined: the loss lags run.pipeline_depth steps, None while it fills
        if out["loss"] is not None:
            loss_m.update(out["loss"])
        examples += len(batch["label"]) * S
        if args.maintenance_every and (i + 1) % args.maintenance_every == 0:
            tr.maintenance()
        if eval_iter is not None and (i + 1) % run_cfg.eval_every == 0:
            eb = next(eval_iter, None)
            if eb is None:
                eval_iter = None
            else:
                ev = tr.eval_step(eb)
                ea = StreamingAUC()
                ea.update(_gather(ev["logits"], mesh), _gather(eb["label"], mesh))
                logger.log(step=tr.step, eval_loss=ev["loss"], eval_auc=ea.compute())
        if (i + 1) % run_cfg.log_every == 0:
            logger.log(step=tr.step, loss=loss_m.mean, auc=_global_auc(tr.auc, mesh),
                       examples_per_sec=examples / (time.perf_counter() - t0),
                       rows=len(tr), **tr.counters())
        if args.ckpt_dir and args.ckpt_every and (i + 1) % args.ckpt_every == 0:
            tr.save_checkpoint(args.ckpt_dir)
    for _s, loss in tr.flush():
        loss_m.update(loss)
    if args.ckpt_dir:
        tr.save_checkpoint(args.ckpt_dir)
    final = {"final_auc": _global_auc(tr.auc, mesh), "steps": tr.step}
    if lead:
        print(json.dumps(final))


def _train_single(args, run_cfg, table_cfg, model_cfg, dev) -> None:
    from meepoembedding_tpu_torch.train import Trainer, train

    spill = _make_spill(args, table_cfg)
    stream = make_train_stream(args.data, run_cfg, model_cfg, 0, 1, bag_len=args.bag_len)
    if args.restore:
        tr = Trainer(run_cfg, table_cfg, model_cfg, device=dev, spill=spill)
        tr.load_checkpoint(args.restore)
        for i, batch in enumerate(stream.batches(run_cfg.steps)):
            tr.train_step(batch)
            if args.maintenance_every and (i + 1) % args.maintenance_every == 0:
                tr.maintenance()
    else:
        eval_stream = None
        if run_cfg.eval_every:  # held-out stream: same source, decorrelated seed
            eval_stream = make_train_stream(
                args.data, dataclasses.replace(run_cfg, seed=run_cfg.seed + 7919),
                model_cfg, 0, 1, bag_len=args.bag_len)
        tr = train(run_cfg, table_cfg, model_cfg, stream,
                   maintenance_every=args.maintenance_every, spill=spill,
                   eval_stream=eval_stream, ckpt_dir=args.ckpt_dir,
                   ckpt_every=args.ckpt_every, device=dev)
    if args.ckpt_dir:
        tr.save_checkpoint(args.ckpt_dir)
    print(json.dumps({"final_auc": tr.auc.compute(), "steps": tr.step}))


def cmd_train(args) -> int:
    grp = load_group_configs(args.config, args.set)
    if grp is not None:
        if _sharded(args):
            with _joined_world(args) as mesh, _profiled(grp[0], mesh.device):
                return _train_group(args, *grp, mesh=mesh)
        return _train_group(args, *grp)
    run_cfg, table_cfg, model_cfg = load_configs(args.config, args.set)
    model_cfg = dataclasses.replace(model_cfg, embedding_dim=table_cfg.dim)
    if args.distributed and args.col_shards > 1:
        from meepoembedding_tpu_torch.parallel.mesh import make_mesh2d

        C, world = args.col_shards, _world()[1]
        if world % C:
            raise SystemExit(f"--col-shards {C} must divide the world of {world} ranks")
        with _joined_world(args) as mesh, _profiled(run_cfg, mesh.device):
            mesh2d = make_mesh2d(world // C, C, device=mesh.device)
            _train_sharded(args, run_cfg, table_cfg, model_cfg, mesh2d.row, mesh2d)
        return 0
    if _sharded(args):
        with _joined_world(args) as mesh, _profiled(run_cfg, mesh.device):
            _train_sharded(args, run_cfg, table_cfg, model_cfg, mesh)
        return 0
    dev = resolve_device(args.device)
    with _profiled(run_cfg, dev):
        _train_single(args, run_cfg, table_cfg, model_cfg, dev)
    return 0


# --- bench-lookup / bench-update ------------------------------------------------------

def _bench_table(args, update: bool) -> int:
    """Ids a second through the table path a training step takes, without
    the tower, with the reference's method (`bench/_common.py`): a table
    of `--rows` slots (max_probe_rounds 2, insert_cap 2^15, rowwise
    AdaGrad) prefilled to 80% with golden-ratio ids, a bounded Zipf(1.05)
    id stream, a dedup capacity of max(1024, batch / 2), the best of 3
    windows of `--steps` steps, and the host read of step i-2's sum as the
    barrier. A lookup step is the dedup, `lookup_train` and the rows in
    batch order; an update step adds the segment sum of their gradients
    and the sparse update."""
    from meepoembedding_tpu_torch.bench._common import (
        IdStream,
        prefill,
        timed_windows,
        to_device,
        train_cycle,
    )
    from meepoembedding_tpu_torch.table.layout import TableSpec, alloc_shard

    dev = resolve_device(args.device)
    rows = int(float(args.rows))
    batch = int(float(args.batch))
    cfg = TableConfig(
        dim=args.dim, capacity=rows,
        optimizer=OptimizerConfig(kind="rowwise_adagrad", learning_rate=0.05),
        max_probe_rounds=2,
        insert_cap=1 << 15,
    )
    spec = TableSpec.from_config(cfg)
    shard = alloc_shard(spec, dev)
    n_live = int(rows * 0.8)
    prefill(dataclasses.replace(spec, insert_cap=None), shard, n_live, min(batch, 1 << 20), 0)
    ucap = max(1024, batch // 2)  # ~35% unique under the zipf stream
    stream = IdStream(n_live, batch, 1.05)
    with torch.no_grad():
        batches = [to_device(stream.ids(), dev) for _ in range(args.steps)]

        def cycle(i: int):
            return train_cycle(spec, shard, *batches[i], ucap, 1, update=update)[0]

        float(cycle(0))  # warm-up
        windows = timed_windows(cycle, args.steps)
    dt = min(windows)
    name = "update" if update else "lookup"
    print(json.dumps({
        "metric": f"{name}_ids_per_sec_per_chip",
        "value": round(batch / dt, 1),
        "unit": "ids/s",
        "rows": rows,
        "ms_per_step": round(dt * 1e3, 3),
    }))
    return 0


def cmd_bench_lookup(args) -> int:
    return _bench_table(args, update=False)


def cmd_bench_update(args) -> int:
    return _bench_table(args, update=True)


# --- serve -------------------------------------------------------------------

def _serve_latency_line(lat_ms, batch_size) -> None:
    """End-of-run latency a batch on stderr (stdout stays one JSON line of
    predictions a batch)."""
    if not lat_ms:
        return
    a = np.asarray(lat_ms[1:] or lat_ms)  # drop the first (warm-up) batch
    print(json.dumps({
        "serve_latency_ms": {
            "p50": round(float(np.percentile(a, 50)), 2),
            "p95": round(float(np.percentile(a, 95)), 2),
            "p99": round(float(np.percentile(a, 99)), 2),
            "mean": round(float(a.mean()), 2),
        },
        "batch_size": batch_size,
        "batches": len(lat_ms),
    }), file=sys.stderr)


def _print_scores(i: int, p: np.ndarray, emit: int) -> None:
    print(json.dumps({"batch": i, "mean_score": float(np.mean(p)),
                      "scores": p[:emit].round(6).tolist()}))


def _serve_http(svc, args, retrieval=None) -> int:
    """Serve `svc` on 127.0.0.1:--http until interrupted."""
    from meepoembedding_tpu_torch.serving import make_http_server

    srv = make_http_server(svc, args.http, retrieval=retrieval)
    print(json.dumps({"serving": f"http://127.0.0.1:{args.http}", **svc.stats()}), flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


def _serve_front(svc, mesh, args, retrieval: bool) -> int:
    """--http over a world of S > 1 ranks: one `LockstepFront` over the
    per-rank service `svc`. Rank 0 serves (with /retrieve when `retrieval`
    and --retrieval-items) and prints until SIGINT or SIGTERM, which stop
    every rank; the other ranks follow it. A failure on rank 0 before it
    serves stops the others."""
    from meepoembedding_tpu_torch.serving import make_http_server
    from meepoembedding_tpu_torch.serving_sharded import LockstepFront

    front = LockstepFront(svc, mesh)
    if mesh.rank:
        return front.follow()
    try:
        ret = _retrieval(front, args) if retrieval else None
        srv = make_http_server(front, args.http, retrieval=ret)
        print(json.dumps({"serving": f"http://127.0.0.1:{args.http}", **front.stats()}),
              flush=True)
    except BaseException:
        front.stop()
        raise
    return front.run(srv)


def _serve_group(args, run_cfg, tables, feature_map, model_cfg) -> int:
    """Scoring from a `tables:` group checkpoint: --http through
    GroupScoringService (one device, or with --distributed over a world of
    S > 1 its members row-sharded behind one front on rank 0), else
    batches through the group eval step (probe-only lookups: unknown ids
    score with zero embeddings), over a world of S > 1 with --distributed
    (each rank scoring its rows, rank 0 printing every rank's scores)."""
    if _sharded(args):
        with _joined_world(args) as mesh:
            if args.http:
                from meepoembedding_tpu_torch.serving_group import GroupScoringService

                svc = GroupScoringService(args.ckpt, run_cfg, tables, feature_map, model_cfg,
                                          distributed=True, mesh=mesh, device=mesh.device)
                return _serve_front(svc, mesh, args, retrieval=False)
            _serve_group_sharded(args, run_cfg, tables, feature_map, model_cfg, mesh)
        return 0
    if args.http:
        from meepoembedding_tpu_torch.serving_group import GroupScoringService

        svc = GroupScoringService(args.ckpt, run_cfg, tables, feature_map, model_cfg,
                                  device=args.device)
        return _serve_http(svc, args)
    from meepoembedding_tpu_torch.group_train import GroupTrainer

    stream = make_train_stream(args.data, run_cfg, model_cfg, 0, 1, bag_len=args.bag_len)
    tr = GroupTrainer(run_cfg, tables, feature_map, model_cfg, device=args.device)
    tr.load_checkpoint(args.ckpt)
    lat_ms = []
    for i, batch in enumerate(stream.batches(run_cfg.steps)):
        t0 = time.perf_counter()
        logits = tr.eval_step(batch)["logits"].cpu().numpy()
        p = 1.0 / (1.0 + np.exp(-np.asarray(logits, np.float64)))
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        _print_scores(i, p, args.emit)
    _serve_latency_line(lat_ms, run_cfg.batch_size)
    return 0


def _serve_group_sharded(args, run_cfg, tables, feature_map, model_cfg, mesh) -> None:
    """Batch scoring of a group checkpoint over a world of S > 1: the
    members restore row-sharded, each rank scores its rows of a batch, and
    rank 0 prints the batch's scores, rank after rank."""
    from meepoembedding_tpu_torch.group_train import ShardedGroupTrainer

    S, rank = mesh.size, mesh.rank
    stream = make_train_stream(args.data, _rank_run_cfg(run_cfg, S), model_cfg, rank, S,
                               bag_len=args.bag_len)
    tr = ShardedGroupTrainer(run_cfg, tables, feature_map, model_cfg, mesh=mesh)
    tr.load_checkpoint(args.ckpt)
    lat_ms = []
    for i, batch in enumerate(_lockstep(stream.batches(run_cfg.steps), mesh)):
        t0 = time.perf_counter()
        p = torch.sigmoid(torch.from_numpy(_gather(tr.eval_step(batch)["logits"], mesh)))
        p = p.numpy()
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        if rank == 0:
            _print_scores(i, p, args.emit)
    if rank == 0:
        _serve_latency_line(lat_ms, run_cfg.batch_size)


def _serve_sharded(args, run_cfg, table_cfg, model_cfg, mesh) -> None:
    """Batch scoring over a world of S > 1: the checkpoint restores
    row-sharded, each rank scores its rows through the eval exchange, and
    rank 0 prints the batch's scores, rank after rank."""
    from meepoembedding_tpu_torch.parallel.trainer import ShardedTrainer

    S, rank = mesh.size, mesh.rank
    batches = _held_out_batches(args, _rank_run_cfg(run_cfg, S), model_cfg, rank, S, cut=True)
    tr = ShardedTrainer(run_cfg, table_cfg, model_cfg, mesh=mesh)
    tr.load_checkpoint(args.ckpt)
    lat_ms = []
    for i, batch in enumerate(_lockstep(batches, mesh)):
        t0 = time.perf_counter()
        p = torch.sigmoid(torch.from_numpy(_gather(tr.eval_step(batch)["logits"], mesh)))
        p = p.numpy()
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        if rank == 0:
            _print_scores(i, p, args.emit)
    if rank == 0:
        _serve_latency_line(lat_ms, run_cfg.batch_size)


def _serve_single(args, run_cfg, table_cfg, model_cfg, dev) -> None:
    """Batch scoring on one device through `ScoringService`: the table and
    tower restored once, probe-only lookups, one JSON line a batch."""
    from meepoembedding_tpu_torch.serving import ScoringService

    svc = ScoringService(args.ckpt, table_cfg, model_cfg, device=dev)
    lat_ms = []
    for i, batch in enumerate(_held_out_batches(args, run_cfg, model_cfg, 0, 1, cut=True)):
        t0 = time.perf_counter()
        p = svc.score(batch["dense"], batch["ids"])  # the host copy is the barrier
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        _print_scores(i, p, args.emit)
    _serve_latency_line(lat_ms, run_cfg.batch_size)


def _retrieval(svc, args):
    """A RetrievalService over `svc` with its index built when
    --retrieval-items names a corpus npz (item_ids [N, IF], optional keys
    [N]) for a two_tower; else None."""
    if not args.retrieval_items:
        return None
    from meepoembedding_tpu_torch.retrieval import RetrievalService

    corpus = np.load(args.retrieval_items)
    retrieval = RetrievalService(svc)
    keys = corpus["keys"] if "keys" in corpus.files else None
    retrieval.build_index(corpus["item_ids"], keys=keys)
    print(json.dumps({"retrieval_index": retrieval.index.num_items}), flush=True)
    return retrieval


def cmd_serve(args) -> int:
    """Scoring from a checkpoint: batch mode streams batches and prints one
    JSON line of predictions a batch, then the latency line on stderr;
    --http serves POST /score (and /retrieve with --retrieval-items).
    Lookups are probe-only: unknown ids score with zero embeddings. A
    `tables:` group config serves the group checkpoint. --http
    --distributed over S > 1 ranks serves from rank 0 through one
    `LockstepFront`, whose requests every rank scores."""
    grp = load_group_configs(args.config, args.set)
    if grp is not None:
        return _serve_group(args, *grp)
    run_cfg, table_cfg, model_cfg = load_configs(args.config, args.set)
    model_cfg = dataclasses.replace(model_cfg, embedding_dim=table_cfg.dim)
    dev = resolve_device(args.device)
    if args.http:
        if args.distributed:
            if args.quantize != "none":
                raise SystemExit("serve --http --distributed serves full-precision rows; "
                                 "drop --quantize (int8 is single-device only)")
            from meepoembedding_tpu_torch.serving_sharded import ShardedScoringService

            # the probe-only exchange path of the sharded service; over S > 1
            # ranks, one front on rank 0 whose requests every rank scores
            with _joined_world(args) as mesh:
                svc = ShardedScoringService(args.ckpt, table_cfg, model_cfg, mesh=mesh)
                if mesh.size > 1:
                    return _serve_front(svc, mesh, args, retrieval=True)
                return _serve_http(svc, args, retrieval=_retrieval(svc, args))
        from meepoembedding_tpu_torch.serving import ScoringService

        svc = ScoringService(args.ckpt, table_cfg, model_cfg, quantize=args.quantize, device=dev)
        return _serve_http(svc, args, retrieval=_retrieval(svc, args))
    if _sharded(args):
        with _joined_world(args) as mesh:
            _serve_sharded(args, run_cfg, table_cfg, model_cfg, mesh)
        return 0
    _serve_single(args, run_cfg, table_cfg, model_cfg, dev)
    return 0


# --- eval --------------------------------------------------------------------

def _held_out_batches(args, run_cfg, model_cfg, rank: int, S: int, cut: bool = False):
    """The batches serve and eval read on this rank: run.steps synthetic
    batches, or one pass (loop=False) over its Criteo lines, cut at
    run.steps when `cut` (serve) and whole otherwise (eval)."""
    if args.data == "synthetic":
        stream = make_train_stream(args.data, run_cfg, model_cfg, rank, S, bag_len=args.bag_len)
        return stream.batches(run_cfg.steps)
    from meepoembedding_tpu_torch.data import CriteoStream

    stream = CriteoStream(_expand_paths(args.data), batch_size=run_cfg.batch_size,
                          loop=False, host_id=rank, num_hosts=S)
    return stream.batches(run_cfg.steps if cut else None)


def _eval_report(tr, batches, mesh=None) -> dict:
    """AUC, mean loss, examples and batches over `batches`; over a world of
    S > 1 the ranks' logits and labels are gathered (the loss is already
    the global mean)."""
    from meepoembedding_tpu_torch.metrics import StreamingAUC

    auc = StreamingAUC()
    losses = []
    n = 0
    for batch in batches:
        out = tr.eval_step(batch)
        if mesh is None:
            logits, labels = out["logits"], np.asarray(batch["label"])
        else:
            logits, labels = _gather(out["logits"], mesh), _gather(batch["label"], mesh)
        auc.update(logits, labels)
        losses.append(float(out["loss"]))
        n += len(labels)
    out = {
        "auc": float(auc.compute()),
        "mean_loss": float(np.mean(losses)) if losses else None,
        "examples": n,
        "batches": len(losses),
    }
    # sharded eval: ids past the exchange's capacity scored zero rows
    if hasattr(tr, "eval_route_drops"):
        out["eval_route_drops"] = int(tr.eval_route_drops)
    return out


def cmd_eval(args) -> int:
    """Offline evaluation from a checkpoint: restore the table and tower,
    stream a labelled dataset with probe-only lookups (unknown ids score
    with zero embeddings, as in serving) and print AUC and mean loss as one
    JSON line; with --retrieval-items, recall@k of a two_tower instead."""
    run_cfg, table_cfg, model_cfg = load_configs(args.config, args.set)
    model_cfg = dataclasses.replace(model_cfg, embedding_dim=table_cfg.dim)
    grp = load_group_configs(args.config, args.set)
    if grp is not None:
        run_cfg, _, _, model_cfg = grp
    dev = resolve_device(args.device)
    if args.retrieval_items:
        from meepoembedding_tpu_torch.retrieval import RetrievalService
        from meepoembedding_tpu_torch.serving import ScoringService

        svc = ScoringService(args.ckpt, table_cfg, model_cfg, device=dev)
        ret = RetrievalService(svc)
        corpus = np.load(args.retrieval_items)
        keys = corpus["keys"] if "keys" in corpus.files else None
        ret.build_index(corpus["item_ids"], keys=keys)
        ks = [int(k) for k in str(args.topk).split(",")]
        print(json.dumps(ret.evaluate(_held_out_batches(args, run_cfg, model_cfg, 0, 1), ks=ks)))
        return 0
    if grp is not None:
        if _sharded(args):
            with _joined_world(args) as mesh:
                out = _eval_sharded(args, run_cfg, table_cfg, model_cfg, mesh, grp)
            if mesh.rank == 0:
                print(json.dumps(out))
            return 0
        from meepoembedding_tpu_torch.group_train import GroupTrainer

        tr = GroupTrainer(*grp, device=dev)
    elif _sharded(args):
        with _joined_world(args) as mesh:
            out = _eval_sharded(args, run_cfg, table_cfg, model_cfg, mesh)
        if mesh.rank == 0:
            print(json.dumps(out))
        return 0
    else:
        from meepoembedding_tpu_torch.train import Trainer

        tr = Trainer(run_cfg, table_cfg, model_cfg, device=dev)
    tr.load_checkpoint(args.ckpt)
    print(json.dumps(_eval_report(tr, _held_out_batches(args, run_cfg, model_cfg, 0, 1))))
    return 0


def _eval_sharded(args, run_cfg, table_cfg, model_cfg, mesh, grp=None) -> dict:
    """`eval --distributed` on this rank of a world of S > 1: the
    checkpoint (a group's, given `grp`) restored row-sharded, this rank's
    rows of every batch."""
    from meepoembedding_tpu_torch.group_train import ShardedGroupTrainer
    from meepoembedding_tpu_torch.parallel.trainer import ShardedTrainer

    if grp is None:
        tr = ShardedTrainer(run_cfg, table_cfg, model_cfg, mesh=mesh)
    else:
        tr = ShardedGroupTrainer(*grp, mesh=mesh)
    tr.load_checkpoint(args.ckpt)
    batches = _held_out_batches(args, _rank_run_cfg(run_cfg, mesh.size), model_cfg, mesh.rank,
                            mesh.size)
    return _eval_report(tr, _lockstep(batches, mesh), mesh)


# --- checkpoints ---------------------------------------------------------------

def cmd_ckpt_export(args) -> int:
    """A checkpoint's rows in a portable format, streamed a data file at a
    time:

      npz   ids [N] int64 + values [N, dim] f32 (+ freq/accum with --full)
      tsv   one line a row: id \\t v0,v1,...
    """
    from meepoembedding_tpu_torch import checkpoint

    m = checkpoint.read_manifest(args.path)
    rows_total = 0
    if args.format == "npz":
        ids_parts, val_parts, extra = [], [], {}
        for data in checkpoint.iter_rows(args.path):
            ids_parts.append(data["ids"])
            val_parts.append(data["values"])
            if args.full:
                for k in ("freq", "accum"):
                    if k in data:
                        extra.setdefault(k, []).append(data[k])
            rows_total += len(data["ids"])
        out = {
            "ids": np.concatenate(ids_parts) if ids_parts else np.zeros(0, np.int64),
            "values": np.concatenate(val_parts) if val_parts else np.zeros((0, m["dim"])),
        }
        for k, v in extra.items():
            out[k] = np.concatenate(v)
        np.savez_compressed(args.out, **out)
    else:
        with open(args.out, "w") as fh:
            for data in checkpoint.iter_rows(args.path):
                for i in range(len(data["ids"])):
                    vals = ",".join(repr(float(x)) for x in data["values"][i])
                    fh.write(f"{int(data['ids'][i])}\t{vals}\n")
                rows_total += len(data["ids"])
    print(json.dumps({"rows": rows_total, "out": args.out, "format": args.format,
                      "dim": m["dim"], "step": m["step"]}))
    return 0


IMPORT_CHUNK = 1 << 14  # rows a table.assign call of ckpt-import


def cmd_ckpt_import(args) -> int:
    """Warm-start a table from a portable row dump (npz: ids [N] int64 +
    values [N, dim]; or tsv: id \\t v0,v1,...), the reverse of ckpt-export:
    the rows are assigned into a fresh table in chunks of IMPORT_CHUNK and
    saved as a checkpoint that train --restore, serve and eval accept.
    Optimizer state starts fresh. Exits 4 when some rows found no slot."""
    from meepoembedding_tpu_torch.table.runtime import DynamicEmbeddingTable

    src = args.src
    fmt = args.format or ("npz" if src.endswith(".npz") else "tsv")
    if fmt == "npz":
        with np.load(src) as z:
            ids = np.asarray(z["ids"], np.int64)
            values = np.asarray(z["values"], np.float32)
    else:
        id_list, row_list = [], []
        with open(src) as fh:
            for line in fh:
                line = line.rstrip("\n")
                if not line:
                    continue
                key, _, vals = line.partition("\t")
                id_list.append(int(key))
                row_list.append([float(x) for x in vals.split(",")])
        ids = np.asarray(id_list, np.int64)
        values = np.asarray(row_list, np.float32) if row_list else np.zeros((0, 0))
    n, dim = values.shape if values.ndim == 2 else (0, 0)
    if len(ids) != n:
        raise ValueError(f"ids [{len(ids)}] vs values [{n}] row mismatch")

    _, table_cfg, _ = load_configs(args.config, args.set)
    if n and table_cfg.dim != dim:  # the file is ground truth for dim
        table_cfg = dataclasses.replace(table_cfg, dim=dim)
    if args.capacity == "auto":
        cap = 1 << 10
        while n > 0.8 * cap:
            cap *= 2
        table_cfg = dataclasses.replace(table_cfg, capacity=max(cap, table_cfg.capacity))
    else:
        table_cfg = dataclasses.replace(table_cfg, capacity=int(float(args.capacity)))

    table = DynamicEmbeddingTable(table_cfg, device=args.device)
    imported = 0
    for o in range(0, n, IMPORT_CHUNK):
        ok = table.assign(ids[o:o + IMPORT_CHUNK], values[o:o + IMPORT_CHUNK])
        imported += int(ok.sum())
    manifest = table.save(args.out)
    print(json.dumps({
        "rows_in_file": int(n), "rows_imported": imported,
        "capacity": table_cfg.capacity, "dim": table_cfg.dim,
        "out": args.out, "step": manifest.get("step", 0),
    }))
    return 0 if imported == n else 4


def _inspect_table_ckpt(path: str) -> dict:
    from meepoembedding_tpu_torch import checkpoint

    out = dict(checkpoint.read_manifest(path))
    rows = 0
    freq_sum = 0
    for data in checkpoint.iter_rows(path):
        rows += len(data["ids"])
        freq_sum += int(data["freq"].sum()) if len(data["ids"]) else 0
    out["total_rows"] = rows
    out["total_hits_recorded"] = freq_sum
    return out


def cmd_ckpt_inspect(args) -> int:
    group_path = os.path.join(args.path, "group.json")
    if os.path.exists(group_path):  # a group checkpoint
        with open(group_path) as f:
            manifest = json.load(f)
        out = dict(manifest)
        out["tables"] = {n: _inspect_table_ckpt(os.path.join(args.path, sub))
                         for n, sub in manifest["tables"].items()}
        out["total_rows"] = sum(t["total_rows"] for t in out["tables"].values())
        print(json.dumps(out, indent=1))
        return 0
    print(json.dumps(_inspect_table_ckpt(args.path), indent=1))
    return 0


# --- the front end ---------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="meepoembedding_tpu_torch",
        description="Dynamic embedding engine on PyTorch + CUDA (the port of "
                    "meepoembedding_tpu)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a CTR/DLRM model on a dynamic table")
    t.add_argument("--config", help="YAML config file")
    t.add_argument("--set", nargs="*", default=[], metavar="sec.key=val",
                   help="dotted overrides, e.g. table.capacity=1e6 run.steps=200")
    t.add_argument("--data", default="synthetic",
                   help="'synthetic' or comma-separated Criteo TSV paths")
    t.add_argument("--bag-len", type=int, default=1,
                   help="synthetic multi-hot bag length L (>1 -> [B,S,L] ids "
                        "pooled by model.combiner; see ops/pooling.py)")
    t.add_argument("--distributed", action="store_true",
                   help="row-shard the table over torchrun's ranks (one process a rank)")
    t.add_argument("--spill", choices=["none", "host", "python", "disk", "redis"],
                   default="none", help="cold-tier backend for evicted rows")
    t.add_argument("--spill-path", help="disk spill log path")
    t.add_argument("--spill-addr", help="redis host:port")
    t.add_argument("--maintenance-every", type=int, default=50)
    t.add_argument("--ckpt-dir", help="save an elastic checkpoint here at the end")
    t.add_argument("--ckpt-every", type=int, default=0)
    t.add_argument("--restore", help="restore from this checkpoint before training")
    t.add_argument("--col-shards", type=int, default=1,
                   help="column (dim) shards for 2-D row x dim table parallelism "
                        "(requires --distributed; N divides the world and dim)")
    t.set_defaults(fn=cmd_train)

    for name, fn in (("bench-lookup", cmd_bench_lookup), ("bench-update", cmd_bench_update)):
        b = sub.add_parser(name, help=f"{name} throughput on one card")
        b.add_argument("--rows", default="1e6", help="table capacity (prefilled to 80%%)")
        b.add_argument("--batch", default="65536")
        b.add_argument("--dim", type=int, default=32)
        b.add_argument("--steps", type=int, default=20)
        b.set_defaults(fn=fn)

    sv = sub.add_parser("serve", help="batch scoring from a checkpoint (no inserts)")
    sv.add_argument("--ckpt", required=True, help="checkpoint directory to restore")
    sv.add_argument("--config", help="YAML config file")
    sv.add_argument("--set", nargs="*", default=[], metavar="sec.key=val")
    sv.add_argument("--data", default="synthetic",
                    help="'synthetic' or comma-separated Criteo TSV paths")
    sv.add_argument("--emit", type=int, default=8,
                    help="scores per batch to include in the JSON output")
    sv.add_argument("--bag-len", type=int, default=1, help="synthetic multi-hot bag length L")
    sv.add_argument("--quantize", choices=["none", "int8"], default="none",
                    help="serve from an int8-quantized read-only table (--http mode)")
    sv.add_argument("--retrieval-items", default=None, metavar="NPZ",
                    help="two_tower only: .npz with item_ids [N, IF] int64 (+ optional "
                         "keys [N]); enables POST /retrieve top-k (--http mode)")
    sv.add_argument("--http", type=int, default=0, metavar="PORT",
                    help="serve an HTTP scoring endpoint on 127.0.0.1:PORT "
                         "(POST /score, GET /healthz) instead of batch mode")
    sv.add_argument("--distributed", action="store_true",
                    help="restore the table row-sharded over torchrun's ranks")
    sv.set_defaults(fn=cmd_serve)

    ev = sub.add_parser("eval", help="offline AUC/loss eval from a checkpoint")
    ev.add_argument("--config", help="YAML config file")
    ev.add_argument("--set", nargs="*", default=[], metavar="sec.key=val")
    ev.add_argument("--ckpt", required=True, help="checkpoint directory")
    ev.add_argument("--data", default="synthetic",
                    help="'synthetic' or comma-separated Criteo TSV paths")
    ev.add_argument("--bag-len", type=int, default=1, help="synthetic multi-hot bag length L")
    ev.add_argument("--distributed", action="store_true",
                    help="restore row-sharded over torchrun's ranks")
    ev.add_argument("--retrieval-items", default=None, metavar="NPZ",
                    help="two_tower only: item corpus (item_ids [N, IF] int64 + optional "
                         "keys [N]); reports recall@k instead of AUC")
    ev.add_argument("--topk", default="1,10,100", help="comma-separated k values for recall@k")
    ev.set_defaults(fn=cmd_eval)

    ce = sub.add_parser("ckpt-export", help="export rows to npz/tsv")
    ce.add_argument("path", help="checkpoint directory")
    ce.add_argument("--out", required=True, help="output file")
    ce.add_argument("--format", choices=["npz", "tsv"], default="npz")
    ce.add_argument("--full", action="store_true", help="include freq/accum state (npz only)")
    ce.set_defaults(fn=cmd_ckpt_export)

    ci = sub.add_parser("ckpt-import", help="warm-start a checkpoint from an npz/tsv row dump")
    ci.add_argument("src", help="input file (.npz: ids+values; or tsv)")
    ci.add_argument("--out", required=True, help="checkpoint directory to write")
    ci.add_argument("--format", choices=["npz", "tsv"], default=None,
                    help="default: by file extension")
    ci.add_argument("--config", help="YAML config file (table.* honored)")
    ci.add_argument("--set", nargs="*", default=[], metavar="sec.key=val")
    ci.add_argument("--capacity", default="auto",
                    help="'auto' (pow2, load<=0.8) or an explicit row count")
    ci.set_defaults(fn=cmd_ckpt_import)

    c = sub.add_parser("ckpt-inspect", help="print checkpoint manifest + stats")
    c.add_argument("path")
    c.set_defaults(fn=cmd_ckpt_inspect)

    for name, sp in sub.choices.items():
        host_only = name in ("ckpt-export", "ckpt-inspect")
        sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="the card (default; raises without one) or the CPU, which "
                             "runs the kernels' plain PyTorch versions"
                             + ("; this command reads npz files on the host and launches "
                                "nothing, so pass cpu where there is no card"
                                if host_only else ""))
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # no card and no --device cpu: raise before any work
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
