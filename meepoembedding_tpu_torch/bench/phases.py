"""Where the headline step's time goes (port of the root
`bench_phases.py`): prefixes of the train cycle timed with the headline's
method at its configuration, so that the difference of two prefixes is
one stage's cost; also the step without the accumulator, the values add
through the library, and the static arms.

    python -m meepoembedding_tpu_torch.bench.phases [--device cuda|cpu]

Logs one line a step, `name  best ms  [windows]`, as the reference does,
and prints one JSON line with the same names and times:
{"metric": "train_cycle_phases_ms", ..., "phases": [{"name", "reference",
"ms"}, ...]}, where "reference" is the reference's name for the step.

The steps, in the reference's order (the port's name, then what it runs):

  1. "dedup only": `unique_pairs`.
  2. "+ lookup_train (probe/plan/gather)".
  3. "+ row_gather by the inverse (fwd out)": the rows in batch order
     (the reference's `rows_for_batch`).
  4. "+ segment_sum_grads" of out * 1e-3 + 1e-4 (the reference's
     `grads_to_window`).
  5. "FULL (rowwise adagrad)": the headline's cycle.
  6. "FULL minus accum (sgd-like)": the values take init - 0.05 g in one
     `scatter_add_values`, no accumulator; the accumulator's cost is 5
     minus 6.
  7. "FULL, library values (index_add_)": 5 with optim's values add
     swapped for one `Tensor.index_add_`, as XLA's scatter-add does.
  8. "STATIC (library index_add_)": a static gather and `index_add_` over
     the same values plane, slots worked out in advance.
  9. "STATIC (segment_sum + row_merge_add)": the headline's
     vs_baseline arm.

The port has no 12 GiB stream-merge threshold: its kernels run at every
plane size, so the reference's switch between the XLA scatter and the
stream-merge kernel (its steps 5 / 7 and 8 / 9) is the switch between
the port's kernels and one library call here. The library arms (7, 8)
are measurement arms only and lie on no path of the port.

Env knobs, the reference's: MEEPO_BENCH_CAP (2^25), MEEPO_BENCH_BATCH
(2^19), MEEPO_BENCH_DIM (32), MEEPO_BENCH_STEPS (20), MEEPO_BENCH_WINDOWS
(3), MEEPO_BENCH_DTYPE (float32), MEEPO_BENCH_FILL (0.75 from 2^27 slots,
else 0.8), MEEPO_BENCH_DEPTH (2), MEEPO_BENCH_UCAP (max(1024, batch / 2)),
MEEPO_BENCH_FETCH_EVERY (4: the host reads step i - depth every 4 steps).
"""

from __future__ import annotations

import contextlib
import dataclasses
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
    prefill,
    start,
    sync,
    timed_windows,
    to_device,
    train_cycle,
    zero_grads,
)
from meepoembedding_tpu_torch.bench.headline import static_cycle, unique_batch
from meepoembedding_tpu_torch.config import OptimizerConfig, TableConfig
from meepoembedding_tpu_torch.kernels import row_gather
from meepoembedding_tpu_torch.ops import dedup, optim
from meepoembedding_tpu_torch.table import table_ops
from meepoembedding_tpu_torch.table.layout import TableSpec, alloc_shard

# (the port's name, the reference's), in the reference's order
STEPS = (
    ("dedup only", "dedup only"),
    ("+ lookup_train (probe/plan/gather)", "+ lookup_train (probe/plan/gather)"),
    ("+ row_gather by the inverse (fwd out)", "+ rows_for_batch (fwd out)"),
    ("+ segment_sum_grads", "+ grads_to_window"),
    ("FULL (rowwise adagrad)", "FULL (rowwise adagrad)"),
    ("FULL minus accum (sgd-like)", "FULL minus accum (sgd-like)"),
    ("FULL, library values (index_add_)", "FULL, stream-merge kernel values"),
    ("STATIC (library index_add_)", "STATIC (xla scatter)"),
    ("STATIC (segment_sum + row_merge_add)", "STATIC (stream-merge kernel)"),
)


def library_values_add(values: torch.Tensor, slot: torch.Tensor, rows: torch.Tensor,
                       enabled: torch.Tensor) -> None:
    """values[slot] += rows where enabled, through one `index_add_` in the
    plane's type: the library arm beside `table_ops.scatter_add_values`.
    Disabled rows add zeros to row 0. A measurement arm only."""
    rows = torch.where(enabled[:, None], rows, 0.0).to(values.dtype)
    values.index_add_(0, slot.clamp(min=0).long(), rows)


@contextlib.contextmanager
def library_values():
    """Inside, `optim`'s updates add their values through
    `library_values_add`: the rest of the update is optim's own code."""
    kernel_add = optim.scatter_add_values
    optim.scatter_add_values = library_values_add
    try:
        yield
    finally:
        optim.scatter_add_values = kernel_add


def static_library_cycle(values: torch.Tensor, slot: torch.Tensor, gseed: float):
    """Step 8: rows = values[slot] (K2), values[slot] -= 0.05 (rows * 1e-3
    + gseed) through `index_add_`, which sums the repeated slots itself."""
    rows = table_ops.gather_values(values, slot)
    g = rows.float() * 1e-3 + gseed
    values.index_add_(0, slot.long(), (-0.05 * g).to(values.dtype))
    return rows.sum()


def run(device="cuda", cap=None, batch=None, dim=None, steps=None, windows=None, dtype=None,
        fill=None, depth=None, ucap=None, fetch_every=None) -> dict:
    """The harness in this process; returns the JSON line's dict. Each
    argument left None reads the reference's environment variable."""
    cap = knob(cap, "MEEPO_BENCH_CAP", 1 << 25)
    batch = knob(batch, "MEEPO_BENCH_BATCH", 1 << 19)
    dim = knob(dim, "MEEPO_BENCH_DIM", 32)
    steps = knob(steps, "MEEPO_BENCH_STEPS", 20)
    # more, shorter windows survive host stalls: the best of W needs one clean one
    nwin = knob(windows, "MEEPO_BENCH_WINDOWS", 3)
    vdtype = knob(dtype, "MEEPO_BENCH_DTYPE", "float32", str)
    fill = knob(fill, "MEEPO_BENCH_FILL", 0.75 if cap >= (1 << 27) else 0.8, float)
    d = knob(depth, "MEEPO_BENCH_DEPTH", 2)
    ucap = knob(ucap, "MEEPO_BENCH_UCAP", max(1024, batch // 2))
    F = knob(fetch_every, "MEEPO_BENCH_FETCH_EVERY", 4)
    dev = start(device)

    cfg = TableConfig(
        dim=dim, capacity=cap, value_dtype=vdtype,
        optimizer=OptimizerConfig(kind="rowwise_adagrad", learning_rate=0.05),
        initializer_scale=0.01, max_probe_rounds=2, insert_cap=1 << 15,
    )
    spec = TableSpec.from_config(cfg)
    log(f"device={device_kind(dev)} cap={cap} batch={batch} dim={dim}")
    shard = alloc_shard(spec, dev)
    n_live = int(spec.capacity * fill)
    t0 = time.perf_counter()
    prefill(dataclasses.replace(spec, insert_cap=None), shard, n_live, min(batch, 1 << 20), 0,
            grads=zero_grads)
    sync(dev)
    log(f"prefill {n_live} in {time.perf_counter() - t0:.1f}s")

    stream = IdStream(n_live, batch, 1.05)
    gseed = 1e-4
    batches = [to_device(stream.ids(), dev) for _ in range(steps)]
    sync(dev)
    out_ms = []

    def timed(name: str, fn, args=batches) -> None:
        """fn(*args[i], step) -> a device scalar, windowed with the fetch
        barrier."""
        float(fn(*args[0], 1))
        ws = timed_windows(lambda i: fn(*args[i], 2 + i), steps, nwin, d, F)
        out_ms.append(min(ws) * 1e3)
        log(f"{name:40s} {min(ws) * 1e3:8.2f} ms   [{fmt_windows(ws)}]")

    def lookup(hi, lo, step):
        uniq = dedup.unique_pairs(hi, lo, ucap)
        return uniq, table_ops.lookup_train(spec, shard, uniq.hi, uniq.lo, uniq.valid, step)

    def g2w(hi, lo, step):
        uniq, ctx = lookup(hi, lo, step)
        out = row_gather(ctx.rows_u, uniq.inverse)
        g = out * 1e-3 + gseed
        g_u = dedup.segment_sum_grads(g, uniq.inverse, ucap, uniq.order, uniq.sorted_ids)
        return ctx, out, g_u

    def v_dedup(hi, lo, step):
        return dedup.unique_pairs(hi, lo, ucap).count

    def v_lookup(hi, lo, step):
        return lookup(hi, lo, step)[1].slot.sum()

    def v_fwd(hi, lo, step):
        uniq, ctx = lookup(hi, lo, step)
        return row_gather(ctx.rows_u, uniq.inverse).sum()

    def v_g2w(hi, lo, step):
        return g2w(hi, lo, step)[2].sum()

    def v_full(hi, lo, step):
        return train_cycle(spec, shard, hi, lo, ucap, step, gseed)[0]

    def v_sgdlike(hi, lo, step):
        ctx, out, g_u = g2w(hi, lo, step)
        enabled = ctx.slot >= 0
        gwin = torch.where(enabled[:, None], g_u, 0.0)
        init_add = torch.where(ctx.fresh[:, None], ctx.rows_u, 0.0)
        table_ops.scatter_add_values(shard.values, ctx.slot, init_add - 0.05 * gwin, enabled)
        return out.sum()

    with torch.no_grad():
        variants = (v_dedup, v_lookup, v_fwd, v_g2w, v_full, v_sgdlike)
        for (name, _), fn in zip(STEPS, variants):
            timed(name, fn)
        with library_values():
            timed(STEPS[6][0], v_full)

        # the static arms on the same values plane, slots and their dedup
        # worked out in advance
        values = shard.values
        slots = [(torch.from_numpy(s.astype(np.int32)).to(dev), *unique_batch(s, batch, dev))
                 for s in stream.rng.integers(0, n_live, size=(steps, batch))]
        sync(dev)
        timed(STEPS[7][0], lambda s, *_: static_library_cycle(values, s, gseed), slots)
        timed(STEPS[8][0], lambda s, su, inv, order, srt, _step: static_cycle(
            values, s, su, inv, order, srt, gseed), slots)
    return {
        "metric": "train_cycle_phases_ms", "capacity": cap, "batch": batch, "dim": dim,
        "dtype": vdtype,
        "phases": [{"name": n, "reference": r, "ms": round(ms, 3)}
                   for (n, r), ms in zip(STEPS, out_ms)],
    }


def main() -> None:
    print(json.dumps(run(parse_device(__doc__))), flush=True)


if __name__ == "__main__":
    main()
