"""Headline benchmark (port of the root `bench.py`): steady-state
dynamic-table throughput on one device. Each timed step is the table's
whole hot path, dedup -> probe/insert -> gather -> rowwise-AdaGrad
update, over a bounded Zipf id stream against a prefilled table.

    python -m meepoembedding_tpu_torch.bench.headline [--device cuda|cpu]

Prints ONE JSON line, the reference's:
  metric  "lookup_update_ids_per_sec_per_chip"
  value   ids processed per second (lookup + in-place update per id)
  vs_baseline  the ratio to a static table on the same values plane with
    slots worked out in advance (no hashing, probe or dedup): its gather
    and add over all `batch` rows, the speed of light of a table that is
    not dynamic. At a stream of about a third unique ids the dynamic path
    touches fewer rows and may beat it (> 1).
  vs_sol_unique  the ratio to the dedup-aware static table: the gather
    and add over only the U unique rows, slots and inverse worked out in
    advance, with the [n] expansion and segment sum that training needs.
    1.0 would mean that hashing, probing and the on-device dedup cost
    nothing.

The static arms reach K1 (`row_merge_add`) only through its contract:
the unique-row add never sees a row twice. The all-rows arm draws its
slots with repeats, so it sums the repeats with `segment_sum` before one
`row_merge_add` over the distinct slots (the reference's XLA scatter-add
summed them itself); the dedup-aware arm pads its unique slots with -1,
which the add drops (the reference padded with slot 0 and added zeros
there). Both arms' slots, dedup and sort are worked out on the host
before the timed windows, as the reference works out its slots.

Env knobs, the reference's: MEEPO_BENCH_CAP (rows, 2^25), MEEPO_BENCH_BATCH
(ids a step, 2^19), MEEPO_BENCH_DIM (32), MEEPO_BENCH_STEPS (20),
MEEPO_BENCH_FILL (0.8), MEEPO_BENCH_DTYPE (float32), MEEPO_BENCH_ROUNDS
(max probe rounds, 2), MEEPO_BENCH_ZIPF (s, 1.05; <= 0 the 94%-unique
mixture), MEEPO_BENCH_UCAP (dedup capacity; default sized from the
stream), MEEPO_BENCH_DEPTH (steps in flight, 2), MEEPO_BENCH_INIT_TIMEOUT
(seconds for the device to come up, 600: past it the JSON line carries an
error and the process exits 3).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time

import numpy as np
import torch

from meepoembedding_tpu_torch.bench._common import (
    IdStream,
    auto_ucap,
    device_kind,
    hbm_bytes,
    knob,
    log,
    parse_device,
    prefill,
    require,
    start,
    sync,
    timed_windows,
    to_device,
    train_cycle,
    zero_grads,
)
from meepoembedding_tpu_torch.config import OptimizerConfig, TableConfig
from meepoembedding_tpu_torch.kernels import row_gather, row_merge_add
from meepoembedding_tpu_torch.ops import dedup
from meepoembedding_tpu_torch.table import table_ops
from meepoembedding_tpu_torch.table.layout import TableSpec, alloc_shard, resolve_device

METRIC = "lookup_update_ids_per_sec_per_chip"


def static_cycle(values: torch.Tensor, slot: torch.Tensor, uslot: torch.Tensor,
                 inverse: torch.Tensor, order: torch.Tensor, sorted_ids: torch.Tensor,
                 gseed: float) -> torch.Tensor:
    """vs_baseline's arm, in place: rows = values[slot], g = rows * 1e-3 +
    gseed, values[slot] -= 0.05 g with repeated slots summed. The slots'
    dedup is worked out in advance (`unique_batch` of the slots: `uslot`,
    the distinct slots padded with -1, `inverse` and its sort). The gather
    is K2; the repeats are summed by `segment_sum` on that sort and the sums
    added by one `row_merge_add` over the distinct slots (K1). Returns the
    rows' sum."""
    rows = table_ops.gather_values(values, slot)
    g = rows.float() * 1e-3 + gseed
    g_u = dedup.segment_sum_grads(-0.05 * g, inverse, uslot.shape[0], order, sorted_ids)
    row_merge_add(values, uslot, g_u)
    return rows.sum()


def static_unique_cycle(values: torch.Tensor, slot_u: torch.Tensor, inverse: torch.Tensor,
                        order: torch.Tensor, sorted_ids: torch.Tensor,
                        gseed: float) -> torch.Tensor:
    """vs_sol_unique's arm, in place: the rows of the unique slots `slot_u`
    (padded with -1), expanded to the batch by `inverse` (both K2), g = out
    * 1e-3 + gseed summed back to the unique rows on the given sort (K1's
    segment sum), values[slot_u] -= 0.05 g_u (K1's unique-row add; the -1
    padding is dropped). Returns the expanded rows' sum."""
    rows_u = table_ops.gather_values(values, slot_u)
    out = row_gather(rows_u, inverse)
    g = out.float() * 1e-3 + gseed
    g_u = dedup.segment_sum_grads(g, inverse, slot_u.shape[0], order, sorted_ids)
    table_ops.scatter_add_values(values, slot_u, -0.05 * g_u, slot_u >= 0)
    return out.sum()


def unique_batch(keys: np.ndarray, ucap: int, dev: torch.device):
    """The static arms' host-side dedup of one batch of keys (used as
    slots): (slot_u [ucap], the distinct keys ascending and padded with -1,
    inverse, order, sorted_ids) on the device, in `static_unique_cycle`'s
    argument order (`static_cycle` takes the slots before them)."""
    uk, inv = np.unique(keys, return_inverse=True)
    inv = inv.reshape(-1).astype(np.int32)
    su = np.full((ucap,), -1, np.int32)
    su[: len(uk)] = uk[:ucap]
    order = np.argsort(inv, kind="stable")
    return tuple(torch.from_numpy(a).to(dev) for a in (su, inv, order, inv[order]))


def run(device="cuda", cap=None, batch=None, dim=None, steps=None, fill=None, dtype=None,
        rounds=None, zipf=None, ucap=None, depth=None) -> dict:
    """The harness in this process; returns the JSON line's dict. Each
    argument left None reads the reference's environment variable."""
    cap = knob(cap, "MEEPO_BENCH_CAP", 1 << 25)
    batch = knob(batch, "MEEPO_BENCH_BATCH", 1 << 19)
    dim = knob(dim, "MEEPO_BENCH_DIM", 32)
    steps = knob(steps, "MEEPO_BENCH_STEPS", 20)
    fill = knob(fill, "MEEPO_BENCH_FILL", 0.8, float)
    vdtype = knob(dtype, "MEEPO_BENCH_DTYPE", "float32", str)
    # max_probe_rounds 2: one 256-slot bucket pair a key. At load 0.8 a pair
    # overflows with P(Poisson(204.8) > 256) ~ 1.6e-4 a key; those inserts
    # are dropped and counted (printed below). 4 rounds drop none.
    rounds = knob(rounds, "MEEPO_BENCH_ROUNDS", 2)
    zipf_s = knob(zipf, "MEEPO_BENCH_ZIPF", 1.05, float)
    d = knob(depth, "MEEPO_BENCH_DEPTH", 2)
    dev = start(device)
    log(f"device: {device_kind(dev)}, cap={cap}, batch={batch}, dim={dim}")

    cfg = TableConfig(
        dim=dim, capacity=cap,
        optimizer=OptimizerConfig(kind="rowwise_adagrad", learning_rate=0.05),
        initializer_scale=0.01, value_dtype=vdtype, max_probe_rounds=rounds,
        # steady-state steps have a handful of misses: capping the inserts a
        # step keeps insert planning at the cap, not the batch (the prefill
        # plans uncapped)
        insert_cap=1 << 15,
    )
    spec = TableSpec.from_config(cfg)
    spec_prefill = dataclasses.replace(spec, insert_cap=None)
    log(f"hbm bytes: {hbm_bytes(spec) / 1e9:.2f} GB, buckets={spec.num_buckets}")
    shard = alloc_shard(spec, dev)

    n_live = int(spec.capacity * fill)
    t0 = time.perf_counter()
    prefill(spec_prefill, shard, n_live, min(batch, 1 << 20), 0, grads=zero_grads)
    sync(dev)
    log(f"prefill {n_live} rows in {time.perf_counter() - t0:.1f}s, "
        f"load={float(shard.cnt.sum()) / spec.capacity:.3f}")

    stream = IdStream(n_live, batch, zipf_s)
    # every U-sized op of the step scales with the dedup capacity, so it is
    # sized from the measured stream, and every timed step is checked not
    # to overflow it (an overflow would alias ids)
    ucap = knob(ucap, "MEEPO_BENCH_UCAP", 0)
    if not ucap and zipf_s <= 0:
        ucap = batch  # the 94%-unique mixture: a lossless capacity
    elif not ucap:
        ucap, u_obs = auto_ucap(stream)
        stream = IdStream(n_live, batch, zipf_s)  # the samples must not skew the timing
        log(f"ucap auto-sized: {u_obs} observed uniques -> cap {ucap} (1.15x)")

    gseed = 1e-4
    with torch.no_grad():
        s0, ucount = train_cycle(spec, shard, *to_device(stream.ids(), dev), ucap, 1, gseed)
        float(s0)
        require(ucap >= batch or int(ucount) < ucap,
                f"dedup capacity overflow: {int(ucount)} uniques >= ucap {ucap}; "
                f"raise MEEPO_BENCH_UCAP")
        log(f"uniques/step ~{int(ucount)} (ucap {ucap})")

        batches = [to_device(stream.ids(), dev) for _ in range(steps)]
        sync(dev)
        ucnts = []  # every timed step's unique count; one max and read after timing

        def dynamic(i):
            acc, ucnt = train_cycle(spec, shard, *batches[i], ucap, 2 + i, gseed)
            ucnts.append(ucnt)
            return acc

        windows = timed_windows(dynamic, steps, 3, d)
        dt = min(windows)
        ucnt_max = int(torch.stack(ucnts).max())
        require(ucap >= batch or ucnt_max < ucap,
                f"dedup capacity overflow during timing: {ucnt_max} >= {ucap}; "
                f"the run is invalid; raise MEEPO_BENCH_UCAP")
        ids_per_sec = batch / dt
        log(f"dynamic: {ids_per_sec / 1e6:.2f}M ids/s (best {dt * 1e3:.2f} ms/step, "
            f"windows {[f'{w * 1e3:.1f}' for w in windows]})")
        c = shard.counters.cpu().numpy()
        log(f"counters: hits={c[0]} misses={c[1]} inserts={c[2]} drops={c[3]} "
            f"(drop rate {c[3] / max(1, c[2] + c[3]):.2e})")

        # --- the static table's speed of light on the same values plane ------
        values = shard.values
        slots_np = stream.rng.integers(0, n_live, size=(steps, batch))
        sbatches = [(torch.from_numpy(s.astype(np.int32)).to(dev), *unique_batch(s, batch, dev))
                    for s in slots_np]
        sync(dev)
        float(static_cycle(values, *sbatches[0], gseed))
        windows = timed_windows(lambda i: static_cycle(values, *sbatches[i], gseed), steps, 3, d)
        dt_sol = min(windows)
        sol_ids_per_sec = batch / dt_sol
        log(f"static SOL: {sol_ids_per_sec / 1e6:.2f}M ids/s (best {dt_sol * 1e3:.2f} ms/step)")

        # --- the dedup-aware speed of light: the same stream's U unique rows,
        # with slots, inverse and sort worked out on the host ------------------
        replay = IdStream(n_live, batch, zipf_s)  # the stream the dynamic arm saw
        ubatches = [unique_batch(replay.keys(), ucap, dev) for _ in range(steps)]
        sync(dev)
        float(static_unique_cycle(values, *ubatches[0], gseed))
        windows = timed_windows(lambda i: static_unique_cycle(values, *ubatches[i], gseed),
                                steps, 3, d)
        dt_sol_u = min(windows)
        sol_u_ids_per_sec = batch / dt_sol_u
        log(f"static SOL (dedup-aware, U~{ucnt_max} rows): "
            f"{sol_u_ids_per_sec / 1e6:.2f}M ids/s (best {dt_sol_u * 1e3:.2f} ms/step)")
    return {
        "metric": METRIC,
        "value": round(ids_per_sec, 1),
        "unit": "ids/s",
        "vs_baseline": round(ids_per_sec / sol_ids_per_sec, 4),
        "vs_sol_unique": round(ids_per_sec / sol_u_ids_per_sec, 4),
    }


def _init_watchdog() -> threading.Event:
    """A device that never comes up would block forever: after
    MEEPO_BENCH_INIT_TIMEOUT seconds without `set()`, print the JSON line
    with an error and exit 3. It reports the failure, and measures
    nothing."""
    done = threading.Event()
    timeout = float(os.environ.get("MEEPO_BENCH_INIT_TIMEOUT", 600))

    def watch():
        if not done.wait(timeout):
            print(json.dumps({
                "metric": METRIC, "value": 0.0, "unit": "ids/s", "vs_baseline": 0.0,
                "error": f"device init timed out after {timeout:.0f}s (CUDA device unreachable)",
            }), flush=True)
            os._exit(3)

    threading.Thread(target=watch, daemon=True).start()
    return done


def main() -> None:
    device = parse_device(__doc__)
    done = _init_watchdog()
    dev = resolve_device(device)
    torch.zeros((1,), device=dev).sum().item()  # the device is up
    done.set()
    print(json.dumps(run(dev)), flush=True)


if __name__ == "__main__":
    main()
