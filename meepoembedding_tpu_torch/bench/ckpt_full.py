"""A checkpoint at full scale (port of the root `bench_ckpt_full.py`): the
streamed save and the elastic restore of a large table on one device,
with sampled rows held bit for bit.

    python -m meepoembedding_tpu_torch.bench.ckpt_full [--device cuda|cpu]

The save streams resumable part files (`checkpoint.save_shard_streamed`);
bf16 values are stored as their raw 2-byte bits (under "<name>@bf16"), so
a row costs ~84 bytes on disk at dim 32. An interrupted run resumes when
run again with the same knobs: the prefill is deterministic (the same
table state), the generation directory keeps its name until the manifest
commits, and the parts already written are skipped without a gather from
the device. After the save the table is freed and restored onto a fresh
one; the sampled ids' rows and accumulators must equal their pre-save
bits, or the run fails.

Prints one JSON line, the reference's: {"metric": "full_scale_checkpoint",
"capacity", "dtype", "rows", "save_s", "gib", "mib_per_s"} and, with the
restore, "restore_s" and "sample_bit_exact".

Env knobs, the reference's: MEEPO_BENCH_CAP (2^27), MEEPO_BENCH_DTYPE
(bfloat16), MEEPO_BENCH_DIM (32), MEEPO_CKPT_DIR (default
meepo_full_ckpt in the temporary directory, TMPDIR else /tmp, where the
reference always writes /tmp/meepo_full_ckpt), MEEPO_CKPT_SAMPLE (200000),
MEEPO_CKPT_CHUNK_ROWS (rows a part, 2^22; read by the checkpoint writer),
MEEPO_CKPT_RESTORE (1; 0 saves only).
"""

from __future__ import annotations

import gc
import json
import os
import tempfile
import time

import numpy as np
import torch

from meepoembedding_tpu_torch import checkpoint
from meepoembedding_tpu_torch.bench._common import (
    MULT,
    device_kind,
    knob,
    log,
    parse_device,
    prefill,
    require,
    start,
    sync,
    to_device,
)
from meepoembedding_tpu_torch.config import OptimizerConfig, TableConfig
from meepoembedding_tpu_torch.kernels import row_gather
from meepoembedding_tpu_torch.table import hashing, table_ops
from meepoembedding_tpu_torch.table.layout import TableSpec, alloc_shard


def trained_grads(ctx) -> torch.Tensor:
    """Non-zero prefill gradients, so that the sampled rows carry trained
    state and not only their init."""
    return ctx.rows_u * 0.01 + 1e-3


def read_rows(spec: TableSpec, shard, hi, lo):
    """(rows, accumulators, found) of the ids (hi, lo): a probe, the values
    gather, the accumulator's gather of its flat plane."""
    pr = table_ops.probe(spec, shard, hi, lo, hashing.is_valid(hi, lo))
    rows = table_ops.lookup_rows(shard, pr.slot)
    acc = (row_gather(shard.opt_rowwise[0].view(-1, 1), pr.slot).view(-1)
           if shard.opt_rowwise else torch.zeros_like(hi, dtype=torch.float32))
    return rows, acc, pr.found


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.cpu()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32).numpy()


def run(device="cuda", cap=None, dim=None, dtype=None, ckpt_dir=None, sample=None,
        restore=None) -> dict:
    """The harness in this process; returns the JSON line's dict. Each
    argument left None reads the reference's environment variable."""
    cap = knob(cap, "MEEPO_BENCH_CAP", 1 << 27)
    dim = knob(dim, "MEEPO_BENCH_DIM", 32)
    vdtype = knob(dtype, "MEEPO_BENCH_DTYPE", "bfloat16", str)
    ckpt_dir = knob(ckpt_dir, "MEEPO_CKPT_DIR",
                    os.path.join(tempfile.gettempdir(), "meepo_full_ckpt"), str)
    n_sample = knob(sample, "MEEPO_CKPT_SAMPLE", 200_000)
    do_restore = knob(restore, "MEEPO_CKPT_RESTORE", "1", str) == "1"
    fill = 0.75 if cap >= (1 << 27) else 0.8  # the reference's f32 at 2^27 needs the room
    dev = start(device)
    cfg = TableConfig(
        dim=dim, capacity=cap, value_dtype=vdtype,
        optimizer=OptimizerConfig(kind="rowwise_adagrad", learning_rate=0.05),
        max_probe_rounds=2,
    )
    spec = TableSpec.from_config(cfg)
    log(f"device={device_kind(dev)} cap={cap} dim={dim} {vdtype}")
    shard = alloc_shard(spec, dev)
    n_live = int(cap * fill)
    t0 = time.perf_counter()
    prefill(spec, shard, n_live, 1 << 20, 1, grads=trained_grads)
    int(shard.counters[0])
    log(f"prefill {n_live} rows in {time.perf_counter() - t0:.1f}s")

    # the pre-save sample, copied to the host for the bit-exact check
    rng = np.random.default_rng(0)
    sample_ids = rng.choice(n_live, size=n_sample, replace=False).astype(np.int64) * MULT
    with torch.no_grad():
        sh, sl = to_device(sample_ids, dev)
        pre_rows, pre_acc, pre_found = read_rows(spec, shard, sh, sl)
        pre_found = pre_found.cpu().numpy()
        # the prefill at load 0.75-0.8 with 2 probe rounds drops a few
        # inserts (counted): sample only live rows, and bound the misses so
        # that a lookup fault cannot hide behind them
        n_missing = int((~pre_found).sum())
        require(n_missing <= max(8, int(n_sample * 1e-4)),
                f"{n_missing}/{n_sample} sampled ids missing: beyond insert-drop noise")
        if n_missing:
            log(f"sample: {n_missing} ids were insert-drops at prefill; "
                f"checking the {n_sample - n_missing} live rows")
            keep = torch.from_numpy(pre_found).to(dev)
            sh, sl, pre_rows, pre_acc = sh[keep], sl[keep], pre_rows[keep], pre_acc[keep]
            n_sample = int(keep.sum())
        pre_rows, pre_acc = _bits(pre_rows), _bits(pre_acc)

        t0 = time.perf_counter()
        manifest = checkpoint.save(ckpt_dir, spec, [shard], step=1)
        save_s = time.perf_counter() - t0
    gdir = os.path.join(ckpt_dir, manifest["dir"])
    nbytes = sum(os.path.getsize(os.path.join(gdir, f)) for f in os.listdir(gdir))
    log(f"save: {save_s:.1f}s, {nbytes / 2**30:.2f} GiB on disk, "
        f"{manifest['counts']} rows, parts={len(os.listdir(gdir))}")
    out = {
        "metric": "full_scale_checkpoint",
        "capacity": cap, "dtype": vdtype, "rows": int(sum(manifest["counts"])),
        "save_s": round(save_s, 1), "gib": round(nbytes / 2**30, 2),
        "mib_per_s": round(nbytes / 2**20 / save_s, 2),
    }
    if do_restore:
        del shard  # free the device memory for the restored copy
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        shards, _ = checkpoint.restore_shards(spec, ckpt_dir, 1, device=dev)
        sync(dev)
        restore_s = time.perf_counter() - t0
        log(f"elastic restore: {restore_s:.1f}s")
        with torch.no_grad():
            post_rows, post_acc, post_found = read_rows(spec, shards[0], sh, sl)
        require(bool(post_found.all()), "the restored table lost sampled ids")
        require(np.array_equal(pre_rows, _bits(post_rows)),
                "sampled rows differ from their pre-save bits after the restore")
        require(np.array_equal(pre_acc, _bits(post_acc)),
                "sampled accumulators differ from their pre-save bits after the restore")
        log(f"sampled {n_sample} rows bit-exact after restore")
        out["restore_s"] = round(restore_s, 1)
        out["sample_bit_exact"] = True
    return out


def main() -> None:
    print(json.dumps(run(parse_device(__doc__))), flush=True)


if __name__ == "__main__":
    main()
