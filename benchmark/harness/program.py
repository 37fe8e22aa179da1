"""The system under test: the port's configuration objects built from a
configuration file, and reads of its table state. Only this module, the
cell runners and `instrument.py` import the port."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from meepoembedding_tpu_torch.config import (
    ModelConfig,
    OptimizerConfig,
    PolicyConfig,
    RunConfig,
    TableConfig,
)
from meepoembedding_tpu_torch.table import hashing, table_ops


# the port's padding id, which fills a bag past its length
PAD_ID = int(hashing.EMPTY_ID)


def model_config(cfg: dict) -> ModelConfig:
    """The port's model settings: every key of the configuration's `model`
    that is a field of `ModelConfig`, lists as tuples. Other keys (such as
    `interaction`, `top_mlp_input`) are the benchmark's own."""
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in cfg["model"].items() if k in fields})


def table_config(cfg: dict) -> TableConfig:
    t, o = cfg["table"], cfg["table"]["optimizer"]
    return TableConfig(
        dim=cfg["model"]["embedding_dim"], capacity=int(t["capacity"]),
        initializer_scale=float(t["initializer_scale"]), initializer=t["initializer"],
        max_probe_rounds=int(t["max_probe_rounds"]), value_dtype=t["value_dtype"],
        optimizer=OptimizerConfig(kind=o["kind"], learning_rate=o["learning_rate"],
                                  eps=o["eps"], initial_accumulator=o["initial_accumulator"]),
        policy=PolicyConfig(admit_threshold=int(t["admit_threshold"])))


def run_config(cfg: dict, batch: int) -> RunConfig:
    return RunConfig(batch_size=batch,
                     dense_learning_rate=float(cfg["dense_optimizer"]["learning_rate"]))


def read_rows(spec, shard, ids: np.ndarray):
    """(rows [n, dim] f32, accumulator [n], found [n] bool) of distinct ids
    as the table holds them; absent ids read zeros."""
    t = torch.from_numpy(np.asarray(ids, np.int64)).to(shard.values.device)
    hi, lo = hashing.split_ids_t(t)
    pr = table_ops.probe(spec, shard, hi, lo, hashing.is_valid(hi, lo))
    slot = torch.where(pr.found, pr.slot, -1)
    rows = table_ops.lookup_rows(shard, slot).float()
    acc = shard.opt_rowwise[0].view(-1)[slot.clamp(min=0).long()]
    return rows, torch.where(pr.found, acc, 0.0), pr.found
