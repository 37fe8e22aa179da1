"""Device layout of one table shard (port of `meepoembedding_tpu/table/layout.py`).

The bucket geometry is the reference's, plane for plane, so slots, drops and
counters compare exactly:

  key planes        key_hi/key_lo int32 [nb, 128]; empty slot == sentinel.
  metadata planes   freq / last int32 [nb, 128]; cnt / ovf int32 [nb].
  optimizer slots   rowwise planes f32 [nb, 128]; full-dim planes like values.
  counters          int32 [16] event counters.
  cms               int32 [4, W] count-min sketch (W == 0 without admission).

The values plane differs: it is row-major `[capacity, dim]` (f32 or bf16),
so slot s is row s. The reference packs 128 // dim rows per 128-lane row
for the TPU's vector width; a GPU gathers a 128-byte row directly.

Shards are updated in place (the reference relied on buffer donation).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from meepoembedding_tpu_torch.config import LANES, OptimizerConfig, PolicyConfig, TableConfig
from meepoembedding_tpu_torch.table import hashing

# counters indices; 8 is ROUTE_DROPS in the reference's sharded table
HITS, MISSES, INSERTS, DROPS, EVICTIONS, SPILLS, PROMOTES, DENIED = range(8)
ERASES = 9
NUM_COUNTERS = 16

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device) -> torch.device:
    """The entry points' device argument. A CUDA device must exist: the port
    never falls back to the CPU silently."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but no CUDA device is visible; pass device='cpu' "
            "to run the plain PyTorch versions on the CPU"
        )
    return dev


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """Static geometry of one table shard."""

    dim: int
    num_buckets: int  # power of two
    initializer_scale: float
    max_probe_rounds: int
    value_dtype: str
    optimizer: OptimizerConfig
    policy: PolicyConfig
    insert_cap: Optional[int] = None
    initializer: str = "uniform"
    # a column block (`parallel/colsharded.py`) holds lanes
    # [init_lane_offset, init_lane_offset + dim) of a wider row; fresh rows
    # draw exactly those lanes' bits (`hashing.default_rows(lane_offset=)`)
    init_lane_offset: int = 0

    @staticmethod
    def from_config(cfg: TableConfig, num_shards: int = 1) -> "TableSpec":
        return TableSpec(
            dim=cfg.dim,
            num_buckets=cfg.buckets_per_shard(num_shards),
            initializer_scale=cfg.initializer_scale,
            initializer=cfg.initializer,
            max_probe_rounds=cfg.max_probe_rounds,
            value_dtype=cfg.value_dtype,
            optimizer=cfg.optimizer,
            policy=cfg.policy,
            insert_cap=cfg.insert_cap,
        )

    @property
    def capacity(self) -> int:
        return self.num_buckets * LANES

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.value_dtype]


@dataclasses.dataclass
class TableShard:
    """All device state of one table shard."""

    key_hi: torch.Tensor  # i32 [nb, 128]
    key_lo: torch.Tensor  # i32 [nb, 128]
    cnt: torch.Tensor  # i32 [nb] live rows per bucket
    ovf: torch.Tensor  # i32 [nb] sticky overflow flag
    freq: torch.Tensor  # i32 [nb, 128]
    last: torch.Tensor  # i32 [nb, 128]
    values: torch.Tensor  # f32/bf16 [capacity, dim]
    opt_rowwise: Tuple[torch.Tensor, ...]  # each f32 [nb, 128]
    opt_fulldim: Tuple[torch.Tensor, ...]  # each like values
    counters: torch.Tensor  # i32 [16]
    cms: torch.Tensor  # i32 [4, W]


def alloc_shard(spec: TableSpec, device) -> TableShard:
    """An empty shard on `device`. Free slots hold zero in every plane but
    the key planes, which hold the empty sentinel."""
    nb = spec.num_buckets
    kshape = (nb, LANES)
    vshape = (spec.capacity, spec.dim)
    i32 = dict(dtype=torch.int32, device=device)
    cms_w = spec.policy.cms_width if spec.policy.admit_threshold > 1 else 0
    return TableShard(
        key_hi=torch.full(kshape, hashing.EMPTY_HI, **i32),
        key_lo=torch.full(kshape, hashing.EMPTY_LO, **i32),
        cnt=torch.zeros((nb,), **i32),
        ovf=torch.zeros((nb,), **i32),
        freq=torch.zeros(kshape, **i32),
        last=torch.zeros(kshape, **i32),
        values=torch.zeros(vshape, dtype=spec.dtype, device=device),
        opt_rowwise=tuple(
            torch.zeros(kshape, dtype=torch.float32, device=device)
            for _ in range(spec.optimizer.num_rowwise_slots())
        ),
        opt_fulldim=tuple(
            torch.zeros(vshape, dtype=spec.dtype, device=device)
            for _ in range(spec.optimizer.num_fulldim_slots())
        ),
        counters=torch.zeros((NUM_COUNTERS,), **i32),
        cms=torch.zeros((4, cms_w), **i32),
    )


def load_factor(spec: TableSpec, shard: TableShard) -> float:
    return float(shard.cnt.sum()) / float(spec.capacity)


def live_mask(shard: TableShard) -> torch.Tensor:
    """[nb, 128] bool: slot holds a live row."""
    return hashing.is_valid(shard.key_hi, shard.key_lo)
