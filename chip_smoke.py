#!/usr/bin/env python3
"""Run the PyTorch + CUDA port's serving path on one card and check it.

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero and prints no result line):

  card     the device's name and power limit (nvidia-smi).
  build    nvcc builds every kernel source of the port (one process each, all
           at once) and prints the -Xptxas -v summary.
  kernels  each kernel against its plain PyTorch version, bit-exactly, at the
           serving path's widths and batch sizes on planes of 2^24 rows:
           int32, f32 and bf16; indices below 0 and at or beyond R; one-hot
           lanes of duplicate rows, set through the plane's flat view.
  serve    the port's main path, with the kernels' launch counters set to 0
           just before it: a one-shard checkpoint in the reference format
           (numpy, from --seed) restores into a ScoringService over a
           2^27-slot dim-32 table (rowwise AdaGrad, f32) with the default
           DLRM tower; `table.assign` fills it toward 100M live rows in
           batches of 65,536; 32 requests of 4096 x 26 one-hot ids (90%
           live, 10% unknown) are scored and timed; one request's rows are
           held against the rows that were written, its scores against the
           tower on the CPU, and one POST /score against the direct score.
  timing   each kernel with CUDA events on the live table's planes, at the
           main path's shapes, beside its plain version, one library call
           and its memory bound (bytes / 3.35 TB/s, H100 SXM); then each
           kernel against its plain version on those inputs (the sets on
           copies of the planes), whose largest difference is max_abs_err.
  profile  torch.profiler over 8 requests and 4 assign batches: wall time,
           device busy time and the heaviest ops of each.

The last lines are the kernels' JSON record, the card's name and power
limit, and {"ok": true, "device": {...}}. `--rehearse-on-cpu` runs the serve
phase on the CPU at the sizes given (with the plain versions) and exits 1
without a result: a dry run of the control flow on machines without a card.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import shutil
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from meepoembedding_tpu_torch import ModelConfig, ScoringService, TableConfig, make_http_server
from meepoembedding_tpu_torch.config import LANES
from meepoembedding_tpu_torch.kernels import (
    _build,
    row_gather,
    row_gather_plain,
    row_scatter_set,
    row_scatter_set_plain,
)
from meepoembedding_tpu_torch.ops import dedup
from meepoembedding_tpu_torch.table import hashing, table_ops

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
CHECK_ROWS_LOG2 = 24  # rows of the planes of the kernel checks


def log(msg: str) -> None:
    print(msg, flush=True)


def parse_args():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--capacity", type=int, default=1 << 27)
    p.add_argument("--fill-rows", type=int, default=100_000_000)
    p.add_argument("--ckpt-rows", type=int, default=1 << 23, help="rows in the checkpoint")
    p.add_argument("--part-rows", type=int, default=1 << 22, help="rows per part file")
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--batch", type=int, default=4096, help="examples per request")
    p.add_argument("--rehearse-on-cpu", action="store_true")
    return p.parse_args()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# --- checkpoint in the reference format ---------------------------------------

def write_checkpoint(path: Path, rng, rows: int, part_rows: int, dim: int,
                     capacity: int, model_cfg, keep: int) -> dict:
    """A one-shard checkpoint as the JAX package writes it: streamed part
    files, a counters sidecar, dense-params.npz and the manifest last.
    Returns all ids and the values of the first `keep` rows."""
    step = 1000
    gen = f"step-{step}"
    gdir = path / gen
    gdir.mkdir(parents=True)
    ids = rng.integers(1, 2**62, size=rows, dtype=np.int64)
    kept = []
    for p, o in enumerate(range(0, rows, part_rows)):
        n = min(part_rows, rows - o)
        # trained rows are small: the table initialises them at scale 0.01
        values = rng.standard_normal((n, dim), dtype=np.float32) * np.float32(0.05)
        kept.append(values[: max(0, keep - o)].copy())
        np.savez(
            gdir / f"shard-00000.part{p:04d}.npz",
            ids=ids[o:o + n],
            values=values,
            freq=rng.integers(1, 100, size=n, dtype=np.int32),
            last=rng.integers(0, step, size=n, dtype=np.int32),
            accum=rng.random(n, dtype=np.float32),
            n_live=np.int64(rows), chunk_rows=np.int64(part_rows), row_off=np.int64(o),
        )
    counters = np.zeros(16, np.int32)
    counters[:4] = [5_000_000, 1_000_000, rows, 0]  # hits, misses, inserts, drops
    np.save(gdir / "shard-00000.counters.npy", counters)
    leaves = []
    d = model_cfg.num_dense_features
    for h in model_cfg.bottom_mlp:
        leaves += [rng.standard_normal((d, h), dtype=np.float32) * np.sqrt(2.0 / d),
                   rng.standard_normal(h, dtype=np.float32) * 0.01]
        d = h
    f = model_cfg.num_sparse_features + 1
    d = model_cfg.embedding_dim + f * (f - 1) // 2
    for h in model_cfg.top_mlp:
        leaves += [rng.standard_normal((d, h), dtype=np.float32) * np.sqrt(2.0 / d),
                   rng.standard_normal(h, dtype=np.float32) * 0.01]
        d = h
    np.savez(gdir / "dense-params.npz", **{f"leaf{j}": x for j, x in enumerate(leaves)})
    manifest = {
        "format": 1, "num_shards": 1, "dim": dim, "capacity_per_shard": capacity,
        "step": step, "value_dtype": "float32",
        "optimizer": {"kind": "rowwise_adagrad", "rowwise_slots": 1, "fulldim_slots": 0},
        "counts": [rows], "dir": gen, "dense": ["params"], "extras": {},
        "counters": [int(x) for x in counters],
    }
    (path / "manifest.json").write_text(json.dumps(manifest, indent=1))
    return {"ids": ids, "values": np.concatenate(kept)}


# --- kernel checks -------------------------------------------------------------

def _bits(x):
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def _onehot_dup_elements(R, n, width, copies, g, dev):
    """n int32 indices into the flat [R * width] view of an [R, width] plane:
    rows repeated `copies` times with one distinct lane each (the one-hot
    writes of duplicate bucket rows), elements of the plane's last rows, and
    indices below 0 and (where int32 holds them) at or beyond R * width."""
    base = torch.randperm(R // 2, device=dev, generator=g)[: n // copies]
    j = torch.arange(n, device=dev)
    span = width // copies
    lane = (j % copies) * span + torch.randint(0, span, (n,), device=dev, generator=g)
    idx = base[j // copies] * width + lane
    top = idx[1::97]
    top.copy_(R * width - 1 - torch.arange(top.shape[0], device=dev))
    idx[2::89] = -1 - torch.arange(idx[2::89].shape[0], device=dev)
    if R * width + n < 2**31:
        idx[3::83] = R * width + torch.arange(idx[3::83].shape[0], device=dev)
    return idx.to(torch.int32)


def check_kernels(rows_log2: int, seed: int) -> None:
    """Each kernel against its plain version; raises unless bit-exact."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    R = 1 << rows_log2

    def gather_case(name, plane, n):
        idx = torch.randint(0, plane.shape[0], (n,), device=dev, dtype=torch.int32, generator=g)
        idx[::101] = -3
        idx[1::103] = plane.shape[0] + 7
        got = row_gather(plane, idx)
        want = row_gather_plain(plane, idx)
        torch.cuda.synchronize()
        exact = torch.equal(_bits(got), _bits(want))
        log(f"check row_gather {name}: plane {tuple(plane.shape)} {plane.dtype}, n={n}: "
            f"{'bit-exact' if exact else 'MISMATCH'}")
        if not exact:
            raise AssertionError(f"row_gather {name} disagrees with its plain version")

    def set_case(name, plane, idx, upd):
        want = plane.clone()
        row_scatter_set(plane, idx, upd)
        row_scatter_set_plain(want, idx, upd)
        torch.cuda.synchronize()
        exact = torch.equal(_bits(plane), _bits(want))
        log(f"check row_scatter_set {name}: plane {tuple(plane.shape)} {plane.dtype}, "
            f"n={idx.shape[0]}: {'bit-exact' if exact else 'MISMATCH'}")
        if not exact:
            raise AssertionError(f"row_scatter_set {name} disagrees with its plain version")

    # int32: the key-pair gather of the probe ([nb/2, 256]) and the bucket
    # gather of insert planning ([nb, 128]), on one buffer of R x 256
    keys = torch.randint(-(2**31), 2**31 - 1, (R, 256), device=dev, dtype=torch.int32,
                         generator=g)
    gather_case("key pairs", keys, 1 << 17)
    gather_case("key buckets", keys.view(2 * R, 128), 1 << 16)
    del keys
    vals = torch.randn((R, 32), device=dev, generator=g)
    gather_case("values f32", vals, 1 << 17)
    gather_case("values bf16", vals.to(torch.bfloat16), 1 << 17)

    n = 1 << 16  # one restore / assign batch
    # one-hot lanes of duplicate rows into an [R, 128] int32 and f32 plane,
    # as elements of its flat [R * 128, 1] view (2^31 elements)
    plane = torch.randint(-(2**31), 2**31 - 1, (R, 128), device=dev, dtype=torch.int32,
                          generator=g)
    idx = _onehot_dup_elements(R, n, 128, 8, g, dev)
    upd = torch.randint(-(2**31), 2**31 - 1, (n, 1), device=dev, dtype=torch.int32,
                        generator=g)
    set_case("key plane int32 one-hot", plane.view(-1, 1), idx, upd)
    plane.view(torch.float32).normal_(generator=g)
    set_case("accum plane f32 one-hot", plane.view(torch.float32).view(-1, 1), idx,
             torch.randn((n, 1), device=dev, generator=g))
    del plane
    # whole rows and one-hot lanes into [R, 32] value planes
    idx = (torch.randperm(R + 64, device=dev, generator=g)[:n] - 32).to(torch.int32)
    set_case("values f32 rows", vals, idx, torch.randn((n, 32), device=dev, generator=g))
    vb = vals.to(torch.bfloat16)
    idx = _onehot_dup_elements(R, n, 32, 4, g, dev)
    set_case("values bf16 one-hot", vb.view(-1, 1), idx,
             torch.randn((n, 1), device=dev, generator=g).to(torch.bfloat16))
    del vals, vb
    torch.cuda.empty_cache()


# --- serving -------------------------------------------------------------------

def make_request(rng, pools, batch, nsparse, unknown_frac=0.1):
    """[batch, nsparse] ids: live ids drawn from `pools` (id arrays, sampled
    in turn), a share of unknown (negative, never inserted) ids."""
    n = batch * nsparse
    ids = np.empty(n, np.int64)
    src = rng.integers(0, len(pools), size=n)
    for k, pool in enumerate(pools):
        sel = src == k
        ids[sel] = pool[rng.integers(0, len(pool), size=int(sel.sum()))]
    unknown = rng.random(n) < unknown_frac
    ids[unknown] = -rng.integers(1, 2**62, size=int(unknown.sum()))
    return ids.reshape(batch, nsparse)


def launches() -> dict:
    return {"row_gather": row_gather.launches, "row_scatter_set": row_scatter_set.launches}


def delta(before: dict, calls: int) -> str:
    now = launches()
    return ", ".join(f"{k} {(now[k] - before[k]) / calls:.2f}" for k in now)


def serve(args, dev, rng, card: str) -> dict:
    dim = 32
    table_cfg = TableConfig(dim=dim, capacity=args.capacity)
    model_cfg = ModelConfig()
    ckpt = ROOT / "build" / "chip_smoke" / "ckpt"
    shutil.rmtree(ckpt.parent, ignore_errors=True)
    t0 = time.perf_counter()
    keep = 1 << 20  # restored rows that requests draw from and are checked against
    written = write_checkpoint(ckpt, rng, args.ckpt_rows, args.part_rows, dim,
                               args.capacity, model_cfg, keep)
    log(f"serve: wrote checkpoint of {args.ckpt_rows} rows in "
        f"{time.perf_counter() - t0:.1f} s")
    try:
        at = launches()
        t0 = time.perf_counter()
        svc = ScoringService(str(ckpt), table_cfg, model_cfg, device=dev)
        sync(dev)
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt.parent, ignore_errors=True)
    table = svc.table
    planes = [getattr(table.shard, f.name) for f in dataclasses.fields(table.shard)]
    planes = [t for p in planes for t in (p if isinstance(p, tuple) else (p,))]
    gib = sum(t.numel() * t.element_size() for t in planes) / 2**30
    log(f"serve: table state {gib:.2f} GiB on {dev}")
    if len(table) != args.ckpt_rows or svc.stats()["step"] != 1000:
        raise AssertionError(f"restored {len(table)} rows at step {svc.stats()['step']}, "
                             f"wrote {args.ckpt_rows} at step 1000")
    nbatch = -(-args.ckpt_rows // min(1 << 16, 1 << max(10, (args.ckpt_rows - 1).bit_length())))
    log(f"serve: restored {len(table)} rows in {restore_s:.2f} s "
        f"({args.ckpt_rows / restore_s:.0f} rows/s) in {nbatch} batches; launches per "
        f"batch: {delta(at, nbatch)}; counters {table.counters()}")

    # fill toward the target live rows with table.assign, data made on the device
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)
    B = 1 << 16
    assigned = landed = 0
    kept_ids, kept_rows = [], []
    at = launches()
    t0 = time.perf_counter()
    while len(table) < args.fill_rows and assigned < args.fill_rows:
        n = min(B, args.fill_rows - args.ckpt_rows - assigned)
        if n <= 0:
            break
        ids = torch.randint(1, 2**62, (n,), device=dev, dtype=torch.int64, generator=g)
        rows = (torch.rand((n, dim), device=dev, generator=g) - 0.5) * 0.1
        ok = table.assign(ids, rows)
        assigned += n
        landed += int(ok.sum())
        if len(kept_ids) < 8:  # rows to check reads against
            okt = torch.from_numpy(ok).to(dev)
            kept_ids.append(ids[okt])
            kept_rows.append(rows[okt])
    sync(dev)
    fill_s = time.perf_counter() - t0
    live = len(table)
    log(f"serve: assigned {assigned} rows in {fill_s:.1f} s ({assigned / fill_s:.0f} rows/s): "
        f"{landed} landed, {assigned - landed} dropped; live rows {live}, "
        f"load {table.load_factor:.4f}; launches per batch: {delta(at, -(-assigned // B))}")
    if landed < 0.99 * assigned:
        raise AssertionError(f"only {landed} of {assigned} assigned rows landed (< 99%)")
    kept_ids = torch.cat(kept_ids)
    kept_rows = torch.cat(kept_rows)

    # requests: live ids from the checkpoint and the fill, 10% unknown
    pools = [written["ids"][:keep], kept_ids.cpu().numpy()]
    nd, ns = model_cfg.num_dense_features, model_cfg.num_sparse_features
    reqs = [(rng.standard_normal((args.batch, nd), dtype=np.float32),
             make_request(rng, pools, args.batch, ns)) for _ in range(args.requests + 3)]
    for dense, ids in reqs[:3]:  # warm-up
        svc.score(dense, ids)
    lat, scores = [], []
    at = launches()
    for dense, ids in reqs[3:]:
        t0 = time.perf_counter()
        p = svc.score(dense, ids)
        lat.append((time.perf_counter() - t0) * 1e3)
        scores.append(p)
        if p.shape != (args.batch,) or not np.all(np.isfinite(p)) or not np.all((p > 0) & (p < 1)):
            raise AssertionError(f"scores must be finite probabilities in (0, 1): "
                                 f"shape {p.shape}, range [{p.min()}, {p.max()}]")
    lat = np.asarray(lat)
    ids_per_req = args.batch * ns
    log(f"serve: {len(lat)} requests of {args.batch} x {ns} ids: p50 {np.percentile(lat, 50):.3f} ms, "
        f"p99 {np.percentile(lat, 99):.3f} ms, mean {lat.mean():.3f} ms, "
        f"{ids_per_req * len(lat) / (lat.sum() / 1e3):.0f} ids/s on {card}; launches per "
        f"request: {delta(at, len(lat))}")

    # one request's rows against the rows that were written (restored from
    # the checkpoint or assigned), and zero rows for the unknown ids
    dense, ids = reqs[3]
    flat = torch.from_numpy(ids.reshape(-1)).to(dev)
    with torch.no_grad():
        got = table.lookup(flat, train=False)
    want = torch.zeros_like(got)
    counts = []
    sources = (
        (torch.from_numpy(written["ids"][:keep]).to(dev),
         torch.from_numpy(written["values"]).to(dev)),
        (kept_ids, kept_rows),
    )
    for src_ids, src_rows in sources:
        order = torch.argsort(src_ids)
        pos = torch.searchsorted(src_ids[order], flat).clamp(max=len(order) - 1)
        hit = src_ids[order][pos] == flat
        want[hit] = src_rows[order[pos[hit]]]
        counts.append(int(hit.sum()))
    unknown = int((flat < 0).sum())
    if sum(counts) + unknown != flat.shape[0]:
        raise AssertionError("the check request holds ids of no known source")
    if not torch.equal(got, want):
        raise AssertionError("looked-up rows differ from the rows written")
    # and against a plain values[slot] of each id's probed slot
    hi, lo = hashing.split_ids_t(flat)
    pr = table_ops.probe(table.spec, table.shard, hi, lo, hashing.is_valid(hi, lo))
    plain = table.shard.values[pr.slot.clamp(min=0).long()] * pr.found[:, None]
    if not torch.equal(got, plain):
        raise AssertionError("looked-up rows differ from values[slot]")
    log(f"serve: request rows equal the rows written and values[slot]: {counts[0]} "
        f"restored ids, {counts[1]} assigned ids, {unknown} unknown ids (zero rows)")

    # the same request's scores against the tower on the CPU, on the rows above
    cpu_model = copy.deepcopy(svc.model).cpu()
    emb = got.cpu().reshape(args.batch, ns, dim)
    with torch.no_grad():
        ref = torch.sigmoid(cpu_model(torch.from_numpy(dense), emb)).numpy()
    np.testing.assert_allclose(scores[0], ref, rtol=1e-5, atol=1e-6)
    log("serve: scores agree with the tower on the CPU (rtol 1e-5, atol 1e-6)")

    # one POST /score through the HTTP server
    server = make_http_server(svc, 0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        body = json.dumps({"dense": dense.tolist(), "ids": ids.tolist()}).encode()
        url = f"http://127.0.0.1:{server.server_address[1]}/score"
        with urllib.request.urlopen(urllib.request.Request(url, data=body), timeout=120) as r:
            http_scores = np.asarray(json.loads(r.read())["scores"])
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=30)
    np.testing.assert_allclose(http_scores, scores[0], atol=1e-6)
    log("serve: POST /score matches the direct score")
    return {"svc": svc, "requests": reqs[3:]}


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


# --- timing --------------------------------------------------------------------

def time_ms(fns, rounds: int = 5, iters: int = 24) -> float:
    """Median over `rounds` of the mean time of one call, cycling through
    `fns` (the same call on different inputs, so that the 50 MB L2 cache
    does not hold the rows of the call before, as it would not on the
    serving path)."""
    for fn in fns:
        fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for i in range(iters):
            fns[i % len(fns)]()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def max_abs_err(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want|, in float64 and in chunks (the planes are up to
    16 GiB); raises unless the two are bit-for-bit equal."""
    got, want = got.reshape(-1), want.reshape(-1)
    err, step = 0.0, 1 << 26
    for i in range(0, got.numel(), step):
        x, y = got[i:i + step], want[i:i + step]
        if not torch.equal(_bits(x), _bits(y)):
            raise AssertionError(f"{name} disagrees with its plain version at the main shape")
        err = max(err, float((x.double() - y.double()).abs().max()))
    return err


def time_kernels(svc, requests, seed: int) -> list:
    """Each kernel at the main path's shapes on the live table's planes,
    on the inputs of 8 requests (gathers) or 8 restore-sized batches (sets),
    then held against its plain version on the same inputs. The timed sets
    write the planes' own contents back, so the table is unchanged; the
    checked sets write new random contents into two copies of the plane,
    one by the kernel and one by the plain version."""
    table = svc.table
    shard, spec = table.shard, table.spec
    dev = shard.values.device
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    out = []

    # each request's unique ids, padded as lookup pads them, and what the
    # lookup gathers for them: found slots and probe bucket pairs
    slots, pgs = [], []
    for _, ids in requests[:8]:
        flat = torch.from_numpy(ids.reshape(-1)).to(dev)
        npad = 1 << (flat.shape[0] - 1).bit_length()
        flat = torch.cat([flat, flat.new_full((npad - flat.shape[0],), int(hashing.EMPTY_ID))])
        uniq = dedup.unique_pairs(*hashing.split_ids_t(flat), npad)
        pr = table_ops.probe(spec, shard, uniq.hi, uniq.lo, uniq.valid)
        slots.append(torch.where(pr.found, pr.slot, 0).to(torch.int32))
        pgs.append(hashing.bucket_of(uniq.hi, uniq.lo, spec.num_buckets) >> 1)
    pairs = shard.key_hi.view(spec.num_buckets // 2, 2 * LANES)

    def entry(label, shape, nbytes, kernel, plain, library, check):
        e = {"label": label, "shape": shape, "ms": time_ms(kernel),
             "plain_ms": time_ms(plain), "library_ms": time_ms(library),
             "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "max_abs_err": check()}
        torch.cuda.empty_cache()
        return e

    def gather_entry(label, plane, idxs):
        n, row_bytes = idxs[0].shape[0], plane.shape[1] * plane.element_size()
        idx64 = [i.long() for i in idxs]
        return entry(
            label, f"{tuple(plane.shape)} {plane.dtype}, n={n}",
            4 * n + 2 * n * row_bytes,  # indices, rows read, rows written
            [lambda i=i: row_gather(plane, i) for i in idxs],
            [lambda i=i: row_gather_plain(plane, i) for i in idxs],
            [lambda i=i: torch.index_select(plane, 0, i) for i in idx64],
            lambda: max(max_abs_err("row_gather", row_gather(plane, i),
                                    row_gather_plain(plane, i)) for i in idxs),
        )

    def set_check(plane, idxs, new_upd):
        got, want = plane.clone(), plane.clone()
        for i in idxs:
            upd = new_upd()
            row_scatter_set(got, i, upd)
            row_scatter_set_plain(want, i, upd)
        return max_abs_err("row_scatter_set", got, want)

    out.append(("row_gather", gather_entry("values per request", shard.values, slots)))
    out.append(("row_gather", gather_entry("key pairs per probe round pair", pairs, pgs)))

    # restore-batch-sized sets of live slots, writing back what is there:
    # one element per slot into the flat key plane, whole rows into the
    # values plane, as insert_rows writes them
    n = 1 << 16
    live = torch.nonzero(shard.key_hi.view(-1) != hashing.EMPTY_HI)[:, 0]
    batches = []
    for _ in range(8):
        pick = live[torch.randperm(live.shape[0], device=dev, generator=g)[:n]]
        keys = shard.key_hi.view(-1)[pick]
        batches.append(dict(slot=pick.to(torch.int32), slot64=pick, keys=keys,
                            upd=keys[:, None].contiguous(), rows=shard.values[pick]))
    set_idx = [x["slot"] for x in batches]
    kf, vals = shard.key_hi.view(-1, 1), shard.values
    out.append(("row_scatter_set", entry(
        "bucket-plane element set per restore batch",
        f"{tuple(kf.shape)} int32 (the {tuple(shard.key_hi.shape)} key plane), n={n}",
        4 * n + 2 * n * 4,  # indices, elements read, elements written
        [lambda x=x: row_scatter_set(kf, x["slot"], x["upd"]) for x in batches],
        [lambda x=x: row_scatter_set_plain(kf, x["slot"], x["upd"]) for x in batches],
        [lambda x=x: kf.view(-1).index_put_((x["slot64"],), x["keys"]) for x in batches],
        lambda: set_check(kf, set_idx, lambda: torch.randint(
            -(2**31), 2**31 - 1, (n, 1), device=dev, dtype=torch.int32, generator=g)),
    )))
    out.append(("row_scatter_set", entry(
        "whole-row values set per restore batch",
        f"{tuple(vals.shape)} f32, n={n}",
        4 * n + 2 * n * spec.dim * 4,  # indices, rows read, rows written
        [lambda x=x: row_scatter_set(vals, x["slot"], x["rows"]) for x in batches],
        [lambda x=x: row_scatter_set_plain(vals, x["slot"], x["rows"]) for x in batches],
        [lambda x=x: vals.index_put_((x["slot64"],), x["rows"]) for x in batches],
        lambda: set_check(vals, set_idx, lambda: torch.randn(
            (n, spec.dim), device=dev, generator=g)),
    )))
    for name, e in out:
        log(f"timing {name} [{e['label']}] {e['shape']}: kernel {e['ms']:.4f} ms, "
            f"plain {e['plain_ms']:.4f} ms, library {e['library_ms']:.4f} ms, "
            f"bound {e['bound_ms']:.4f} ms (bytes); max |kernel - plain| "
            f"{e['max_abs_err']}")
    return out


def profile_phase(svc, reqs, seed: int) -> None:
    """Device busy share and the heaviest ops of scoring and of assign."""
    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    dim = svc.table_cfg.dim
    batches = [(torch.randint(1, 2**62, (1 << 16,), device="cuda", generator=g),
                torch.rand((1 << 16, dim), device="cuda", generator=g)) for _ in range(4)]
    work = {
        "score": (lambda: [svc.score(d, i) for d, i in reqs[:8]], 8),
        "assign": (lambda: [svc.table.assign(i, r) for i, r in batches], 4),
    }
    for name, (fn, count) in work.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        ka = prof.key_averages()
        on_device = [e for e in ka if e.device_type.name == "CUDA"]
        busy_us = sum(device_us(e) for e in on_device)
        kernels = sum(e.count for e in on_device)
        top = sorted(ka, key=device_us, reverse=True)[:8]
        log(f"profile {name}: {count} calls, wall {wall_us / count / 1e3:.3f} ms/call, device "
            f"busy {busy_us / count / 1e3:.3f} ms/call ({100 * busy_us / wall_us:.1f}% of wall), "
            f"{kernels / count:.0f} device kernels and copies per call")
        for e in top:
            log(f"profile {name}:   {e.key[:70]:70s} {device_us(e) / count:9.1f} us/call "
                f"x{e.count // count}")


# --- main ----------------------------------------------------------------------

def main() -> int:
    args = parse_args()

    rehearse = args.rehearse_on_cpu
    if not rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(args.seed)
    t_start = time.perf_counter()

    if rehearse:
        log("rehearsal on the CPU: plain versions, no build, no timing, no result")
        serve(args, torch.device("cpu"), rng, "the CPU (rehearsal)")
        log(f"rehearsal finished in {time.perf_counter() - t_start:.1f} s")
        return 1

    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"card: {kind} | nvidia-smi: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.build()
    log(f"build: {', '.join(_build.KERNELS)} in {time.perf_counter() - t0:.1f} s")
    for name, report in _build.ptxas_reports.items():
        for line in report.splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line or "Compiling" in line):
                log(f"build {name}: {line.strip()}")

    t0 = time.perf_counter()
    check_kernels(CHECK_ROWS_LOG2, args.seed)
    log(f"kernels: checks passed in {time.perf_counter() - t0:.1f} s")

    row_gather.launches = 0
    row_scatter_set.launches = 0
    t0 = time.perf_counter()
    res = serve(args, torch.device("cuda"), rng, card)
    counts = launches()
    log(f"serve: main path finished in {time.perf_counter() - t0:.1f} s; launches {counts}")
    for name, count in counts.items():
        if count <= 0:
            raise AssertionError(f"the main path never launched {name}")

    timings = time_kernels(res["svc"], res["requests"], args.seed)
    profile_phase(res["svc"], res["requests"], args.seed)
    meta = {
        "row_gather": ("meepoembedding_tpu_torch/csrc/row_gather.cu",
                       "meepoembedding_tpu/table/pallas_ops.py:58"),
        "row_scatter_set": ("meepoembedding_tpu_torch/csrc/row_scatter_set.cu",
                            "meepoembedding_tpu/table/pallas_ops.py:200 + "
                            "meepoembedding_tpu/table/stream_merge.py:224"),
    }
    kernels = []
    for name in ("row_gather", "row_scatter_set"):
        mine = [t for n, t in timings if n == name]
        e = mine[0]  # the main shape
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
            "launches": counts[name], "max_abs_err": max(t["max_abs_err"] for t in mine),
            "ms": e["ms"],
            "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"], "bound_by": "bytes",
            "library_ms": e["library_ms"], "shape": e["shape"],
        })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
