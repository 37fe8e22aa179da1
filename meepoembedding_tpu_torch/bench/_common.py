"""What the harnesses share, copied from the reference's root scripts
(`bench.py:104-183`, `bench_phases.py:45-108`) so that the port imports
nothing of the JAX package.

  knob           an argument, else the reference's environment variable,
                 else its default
  start          the device, with the card's name and power limit (or
                 "cpu") on stderr before anything else
  prefill        golden-ratio ids 0..rows-1 into a table, in batches
  IdStream       the bounded Zipf(s) id stream (or the reference's
                 two-uniform mixture at s <= 0), in its numpy draw order
  auto_ucap      the dedup capacity sized from 5 sample batches
  train_cycle    dedup -> lookup_train -> rows -> segment sum -> update
  timed_windows  best-of-W windows, a host read of step i - d the barrier
  world          the process group's mesh, or a world of one

Every number a harness prints is the device's own: `start` refuses a card
that is not there (`resolve_device`), and nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys
import time
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from meepoembedding_tpu_torch.config import LANES
from meepoembedding_tpu_torch.kernels import row_gather
from meepoembedding_tpu_torch.ops import dedup, optim
from meepoembedding_tpu_torch.parallel import mesh as pmesh
from meepoembedding_tpu_torch.table import hashing, table_ops
from meepoembedding_tpu_torch.table.layout import TableShard, TableSpec, resolve_device

# golden-ratio multiplier: the reference's ids are index * MULT (int64, wrapping)
MULT = np.int64(0x9E3779B97F4A7C15 & 0x7FFFFFFFFFFFFFFF)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def knob(value, env: str, default, cast=int):
    """`value` when the caller gives one, else the environment variable
    `env` (the reference script's name), else `default` (its default)."""
    if value is not None:
        return cast(value)
    return cast(os.environ.get(env, default))


def parse_device(doc: str) -> str:
    """The harnesses' one flag: `--device {cuda,cpu}`, cuda by default."""
    p = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (the default) raises without a card; cpu runs the plain "
                        "PyTorch versions of the kernels")
    return p.parse_args().device


def card_line(dev: torch.device) -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the card, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    lines = out.stdout.strip().splitlines()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return lines[index] if index < len(lines) else lines[0]


def start(device) -> torch.device:
    """The harness's device (a CUDA device must exist), its card line
    printed on stderr first."""
    dev = resolve_device(device)
    log(card_line(dev))
    return dev


def device_kind(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def require(ok: bool, msg: str) -> None:
    """A check of the run itself: raises (the module exits non-zero), also
    under `python -O`."""
    if not ok:
        raise AssertionError(msg)


def hbm_bytes(spec: TableSpec) -> int:
    """Device bytes of one shard's planes (the reference's
    `TableSpec.hbm_bytes`): the values and full-dim planes, the key, freq
    and last planes and the rowwise ones."""
    itemsize = torch.empty((), dtype=spec.dtype).element_size()
    values = spec.capacity * spec.dim * itemsize * (1 + spec.optimizer.num_fulldim_slots())
    keys_meta = spec.num_buckets * LANES * 4 * (4 + spec.optimizer.num_rowwise_slots())
    return values + keys_meta


@contextlib.contextmanager
def world(dev: torch.device):
    """The mesh of the process group this process is in; without one, a
    world of one on `dev` (the reference's `make_mesh()` on one device),
    which is left again at the end."""
    own = not dist.is_initialized()
    try:
        yield pmesh.make_mesh(device=dev)
    finally:
        if own:
            pmesh.destroy()


def to_device(ids: np.ndarray, dev: torch.device):
    """int64 ids -> (hi, lo) int32 on `dev`."""
    hi, lo = hashing.split_ids(ids)
    return torch.from_numpy(hi).to(dev), torch.from_numpy(lo).to(dev)


def prefill(spec: TableSpec, shard: TableShard, rows: int, batch: int, step: int,
            grads: Optional[Callable] = None) -> None:
    """Insert the ids i * MULT for i in [0, rows), in batches of `batch`
    ids, the last padded with the invalid id. With `grads` (a function of
    `table_ops.LookupCtx` -> [U, dim] gradient rows) each batch goes
    through `lookup_train` and `apply_sparse_grads_ctx`, as the reference's
    fused prefill (`bench.py:115-145`): fresh rows take their init plus the
    update; without, through `insert_rows` of the init rows, as the
    reference's `find_or_insert` (`cli.py`, `bench_stages.py`). A host read
    of a counter every 4 batches caps the work in flight."""
    dev = shard.key_hi.device
    # a table of fewer rows than a batch takes one batch of its rows: the
    # reference's padding with invalid ids changes no slot and no counter
    batch = min(batch, rows)
    with torch.no_grad():
        for i in range(0, rows, batch):
            n = min(batch, rows - i)
            ids = np.arange(i, i + n, dtype=np.int64) * MULT
            if n < batch:
                ids = np.concatenate([ids, np.full(batch - n, hashing.EMPTY_ID)])
            hi, lo = to_device(ids, dev)
            valid = hashing.is_valid(hi, lo)
            if grads is None:
                init = hashing.default_rows(hi, lo, spec.dim, spec.initializer_scale, spec.dtype,
                                            kind=spec.initializer,
                                            lane_offset=spec.init_lane_offset)
                table_ops.insert_rows(spec, shard, hi, lo, init, valid, step)
            else:
                ctx = table_ops.lookup_train(spec, shard, hi, lo, valid, step)
                optim.apply_sparse_grads_ctx(spec, shard, ctx, grads(ctx))
            if (i // batch) % 4 == 3:
                int(shard.counters[0])


def zero_grads(ctx) -> torch.Tensor:
    """The prefill's gradient rows when the rows should stay at their init."""
    return torch.zeros_like(ctx.rows_u)


class IdStream:
    """The reference's steady-state id stream over `n_live` live keys:
    each batch draws `u = rng.random(batch)` and takes the bounded Zipf(s)
    rank k = ((n^(1-s) - 1) u + 1)^(1/(1-s)), clipped to n, minus one; at
    s <= 0 the two-uniform mixture of round 1 (80% from the hottest tenth).
    Keys are ranks in [0, n_live); ids are keys * MULT. `rng` is the
    stream's numpy generator, which the reference also draws the static
    slots from."""

    def __init__(self, n_live: int, batch: int, zipf_s: float = 1.05, seed: int = 0):
        self.n_live, self.batch, self.zipf_s = n_live, batch, zipf_s
        self.rng = np.random.default_rng(seed)

    def keys(self) -> np.ndarray:
        rng, n_live, batch = self.rng, self.n_live, self.batch
        if self.zipf_s <= 0:
            hot = rng.integers(0, max(1, n_live // 10), size=int(batch * 0.8))
            cold = rng.integers(0, n_live, size=batch - len(hot))
            return np.concatenate([hot, cold])
        t = 1.0 - self.zipf_s  # inverse CDF of p(k) ~ k^-s over [1, n_live]
        u = rng.random(batch)
        k = ((float(n_live) ** t - 1.0) * u + 1.0) ** (1.0 / t)
        return np.minimum(k.astype(np.int64), n_live) - 1

    def ids(self) -> np.ndarray:
        return self.keys() * MULT


def auto_ucap(stream: IdStream) -> tuple:
    """(ucap, observed): the dedup capacity sized from the measured stream
    (`bench.py:171-183`): the most uniques of 5 sample batches, times
    1.15, rounded up to a multiple of 128, at most the batch. The samples
    advance the stream's generator; the caller starts a fresh stream."""
    u_obs = max(len(np.unique(stream.ids())) for _ in range(5))
    return min(stream.batch, -(-int(u_obs * 1.15) // 128) * 128), u_obs


def train_cycle(spec: TableSpec, shard: TableShard, hi, lo, ucap: int, step: int,
                gseed: float = 0.0, update: bool = True):
    """One step of the table path without the tower, in place: dedup ->
    `lookup_train` -> the rows in batch order (`row_gather` by the inverse)
    and, with `update`, synthetic gradients out * 1e-3 + gseed -> their
    segment sum on the dedup's sort -> `apply_sparse_grads_ctx`. Returns
    (sum of the rows, the unique count), both on the device. The
    reference's `rows_for_batch` / `grads_to_window` are its 128-lane
    window forms of the gather and the segment sum; the port has one
    row-major path for every dim."""
    uniq = dedup.unique_pairs(hi, lo, ucap)
    ctx = table_ops.lookup_train(spec, shard, uniq.hi, uniq.lo, uniq.valid, step)
    out = row_gather(ctx.rows_u, uniq.inverse)
    if update:
        g = out * 1e-3
        if gseed:
            g += gseed
        g_u = dedup.segment_sum_grads(g, uniq.inverse, ucap, uniq.order, uniq.sorted_ids)
        optim.apply_sparse_grads_ctx(spec, shard, ctx, g_u)
    return out.sum(), uniq.count


def timed_windows(step: Callable[[int], torch.Tensor], n: int, windows: int = 3,
                  depth: int = 2, fetch_every: int = 1) -> List[float]:
    """Seconds a step in each of `windows` windows of `n` steps. `step(i)`
    enqueues step i and returns a device scalar; the host reads step i -
    depth's scalar every `fetch_every` steps (a real completion barrier
    that caps the work in flight and hides behind the steps in flight) and
    the last one at the window's end. Training runs pipelined, so the best
    window is the steady-state reading: a host stall can only inflate
    one."""
    out = []
    for _ in range(windows):
        t0 = time.perf_counter()
        accs = []
        for i in range(n):
            accs.append(step(i))
            if i >= depth and i % fetch_every == 0:
                float(accs[i - depth])
        float(accs[-1])
        out.append((time.perf_counter() - t0) / n)
    return out


def fmt_windows(ws: List[float]) -> str:
    """The windows' ms a step, as the reference's log lines print them."""
    return ",".join(f"{w * 1e3:.0f}" for w in ws)
