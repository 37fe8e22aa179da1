"""Checkpoint restore (port of the reading half of
`meepoembedding_tpu/checkpoint.py`: :111-136, :186-228, :346-348, :607-797).

The on-disk format is the reference's, so a checkpoint written by the JAX
package restores here with bit-exact rows:

  manifest.json       {"format", "num_shards", "dim", "step", "value_dtype",
                       "optimizer", "counts", "counters", "dir", "dense", ...}
  <dir>/shard-SSSSS.npz or shard-SSSSS.partPPPP.npz
                      ids i64[n], values [n, dim], freq i32[n], last i32[n],
                      accum f32[n], full0.. [n, dim]; bf16 arrays are stored
                      as raw uint16 bits under "<name>@bf16"
  <dir>/shard-SSSSS.colCC.npz   column-sharded blocks, merged on read
  <dir>/dense-<name>.npz        dense pytree leaves leaf0, leaf1, ... in
                                jax.tree_util flatten order

Restore rehashes every saved row into a fresh shard, batch by batch. Slot
placement depends on the batches, so they are the reference's: rows in file
order, in batches of the smaller of `batch` (65,536) and the least power of
two >= 1024 that holds the whole checkpoint.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, List, Tuple

import numpy as np
import torch

from meepoembedding_tpu_torch.table import hashing, table_ops
from meepoembedding_tpu_torch.table.layout import TableShard, TableSpec, alloc_shard

FORMAT_VERSION = 1
_RESTORE_BATCH = 1 << 16
_META = ("n_live", "chunk_rows", "row_off")  # part-file resume metadata


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """Raw bfloat16 bits (uint16) -> the exact float32 values."""
    return (bits.astype(np.uint32) << np.uint32(16)).view(np.float32)


def _decode_arrays(z) -> dict:
    out = {}
    for k in z.files:
        a = z[k]
        if k.endswith("@bf16"):
            out[k[:-5]] = _bf16_bits_to_f32(a.view(np.uint16))
        else:
            out[k] = a
    return out


def _shard_files(d: str, i: int) -> List[str]:
    """Shard i's data files in row order: the legacy single file or the
    streamed part files."""
    single = os.path.join(d, f"shard-{i:05d}.npz")
    if os.path.exists(single):
        return [single]
    parts = sorted(
        f for f in os.listdir(d)
        if f.startswith(f"shard-{i:05d}.part") and f.endswith(".npz")
    )
    return [os.path.join(d, f) for f in parts]


def _data_dir(path: str, manifest: dict) -> str:
    return os.path.join(path, manifest.get("dir", ""))


def read_manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    if m["format"] > FORMAT_VERSION:
        raise ValueError(f"checkpoint from a newer format: {m['format']}")
    return m


def iter_rows(path: str) -> Iterator[dict]:
    """Stream the checkpoint's data files one at a time as dicts of numpy
    arrays; column-sharded files are merged into full-dim rows."""
    m = read_manifest(path)
    d = _data_dir(path, m)
    C = int(m.get("col_shards", 1))
    for i in range(m["num_shards"]):
        if C <= 1:
            files = _shard_files(d, i)
            if not files:
                raise FileNotFoundError(f"checkpoint {path}: no data files for shard {i}")
            for fp in files:
                with np.load(fp) as z:
                    out = _decode_arrays(z)
                for meta in _META:
                    out.pop(meta, None)
                yield out
            continue
        cols = []
        for c in range(C):
            with np.load(os.path.join(d, f"shard-{i:05d}.col{c:02d}.npz")) as z:
                cols.append({k: z[k] for k in z.files})
        for c in range(1, C):
            if not np.array_equal(cols[0]["ids"], cols[c]["ids"]):
                raise ValueError(f"shard {i}: column {c} export out of lockstep")
        merged = {
            k: v for k, v in cols[0].items()
            if k not in ("values", "lane_offset") and not k.startswith("full")
        }
        order = np.argsort([int(c["lane_offset"]) for c in cols])
        for k in [k for k in cols[0] if k == "values" or k.startswith("full")]:
            merged[k] = np.concatenate([cols[int(j)][k] for j in order], axis=1)
        yield merged


def load_dense(path: str, name: str) -> List[np.ndarray]:
    """The leaves of the dense pytree saved under `name`, in jax.tree_util
    flatten order (for the DLRM params: bottom w0, b0, w1, b1, ..., then top).
    `weights.from_jax_params` maps them onto a module and checks shapes."""
    d = _data_dir(path, read_manifest(path))
    with np.load(os.path.join(d, f"dense-{name}.npz")) as z:
        return [z[f"leaf{j}"] for j in range(len(z.files))]


def restore_shards(
    spec: TableSpec, path: str, num_shards: int = 1, batch: int = _RESTORE_BATCH,
    device="cuda",
) -> Tuple[List[TableShard], dict]:
    """Rebuild `num_shards` fresh shards on `device` from a checkpoint written
    with any shard count: every saved row is rehashed to its owner shard and
    bulk-inserted. Raises if any row finds no slot (the target capacity is
    too small), never truncating silently. The saved lifetime counters land
    on shard 0; the restore's own inserts are not history."""
    m = read_manifest(path)
    if m["dim"] != spec.dim:
        raise ValueError(f"dim mismatch: ckpt {m['dim']} vs spec {spec.dim}")
    if m["optimizer"]["kind"] != spec.optimizer.kind:
        raise ValueError(
            f"optimizer mismatch: ckpt {m['optimizer']['kind']} vs {spec.optimizer.kind}"
        )
    if m.get("counts"):
        total = max(1, sum(m["counts"]))
        b = 1024
        while b < min(batch, total):
            b *= 2
        batch = min(batch, b)
    shards = [alloc_shard(spec, device) for _ in range(num_shards)]
    n_full = spec.optimizer.num_fulldim_slots()
    step = m["step"]
    valid_all = torch.arange(batch, device=device)
    fills = {"hi": hashing.EMPTY_HI, "lo": hashing.EMPTY_LO}  # padding; others pad 0

    for data in iter_rows(path):
        if data["ids"].shape[0] == 0:
            continue
        hi_np, lo_np = hashing.split_ids(data["ids"])
        owner = hashing.owner_of(torch.from_numpy(hi_np), torch.from_numpy(lo_np),
                                 num_shards).numpy()
        cols = {
            "hi": hi_np, "lo": lo_np, "values": data["values"], "freq": data["freq"],
            "last": data["last"],
        }
        if "accum" in data:
            cols["accum"] = data["accum"]
        for j in range(n_full):
            cols[f"full{j}"] = data[f"full{j}"]
        on_dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                  for k, v in cols.items()}
        for s in range(num_shards):
            sel = torch.from_numpy(np.nonzero(owner == s)[0]).to(device)
            for o0 in range(0, sel.shape[0], batch):
                idx = sel[o0:o0 + batch]
                n = idx.shape[0]

                def pick(k):
                    x = on_dev[k][idx]
                    if n < batch:
                        pad = x.new_full((batch - n,) + x.shape[1:], fills.get(k, 0))
                        x = torch.cat([x, pad])
                    return x

                valid = valid_all < n
                ok = table_ops.insert_rows(
                    spec, shards[s], pick("hi"), pick("lo"), pick("values"), valid,
                    step, freq=pick("freq"), last=pick("last"),
                    accum=pick("accum") if "accum" in on_dev else None,
                    fulldim=[pick(f"full{j}") for j in range(n_full)] or None,
                )
                lost = int((valid & ~ok).sum())
                if lost:
                    raise RuntimeError(
                        f"restore dropped {lost} rows on shard {s}: the target "
                        f"capacity ({spec.capacity}/shard x {num_shards}) cannot "
                        f"hold the checkpoint's {sum(m.get('counts', []))} live "
                        "rows; raise table.capacity (or set table.grow_at_load)"
                    )
    saved = m.get("counters")
    if saved is not None:
        for s, shard in enumerate(shards):
            shard.counters.zero_()
            if s == 0:
                vals = np.asarray(saved, np.int64)[: shard.counters.shape[0]]
                shard.counters[: len(vals)] = torch.from_numpy(vals.astype(np.int32))
    return shards, m
