"""Checkpoints in the reference's format (port of
`meepoembedding_tpu/checkpoint.py`: the writer, :54-600, with the
multi-process protocol and the column-sharded `save_sharded2d`, and the
reader, :607-797, with `restore_shards(lane_slice=)`).

The on-disk format is the reference's, so a checkpoint written by either
package restores into the other with bit-exact rows:

  manifest.json       {"format", "num_shards", "dim", "capacity_per_shard",
                       "step", "value_dtype", "optimizer", "counts",
                       "counters", "dir", "dense", "extras"}
  step-N[.k]/         one generation directory a save; the manifest's "dir"
    shard-SSSSS.partPPPP.npz   streamed parts: ids i64[n], values [n, dim],
                      freq i32[n], last i32[n], accum f32[n], full0..
                      [n, dim], in ascending live-slot order, plus the
                      resume metadata n_live, chunk_rows, row_off; bf16
                      arrays are stored as raw uint16 bits under
                      "<name>@bf16"
    shard-SSSSS.npz   the single-file layout of an async save (f32 rows)
    shard-SSSSS.counters.npy   the shard's lifetime counters
    shard-SSSSS.colCC.npz      column-sharded blocks, merged on read
    dense-<name>.npz  dense pytree leaves leaf0, leaf1, ... in
                      jax.tree_util flatten order

A save writes a fresh generation directory, every file through an atomic
rename, and commits by writing the manifest last; stale generations are
pruned after the commit, so a save that dies midway leaves the previous
checkpoint loadable. `MEEPO_CKPT_CHUNK_ROWS` (rows a part, 2^22) and
`MEEPO_CKPT_COMPRESS=1` (deflated parts) set the layout, as in the
reference.

Restore rehashes every saved row into a fresh shard, batch by batch. Slot
placement depends on the batches, so they are the reference's: rows in file
order, in batches of the smaller of `batch` (65,536) and the least power of
two >= 1024 that holds the whole checkpoint.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from meepoembedding_tpu_torch.kernels import row_gather_multi
from meepoembedding_tpu_torch.table import hashing, table_ops
from meepoembedding_tpu_torch.table.layout import TableShard, TableSpec, alloc_shard, live_mask

FORMAT_VERSION = 1
_RESTORE_BATCH = 1 << 16
_META = ("n_live", "chunk_rows", "row_off")  # part-file resume metadata
_EXPORT_CHUNK = 1 << 22  # live rows gathered a chunk: 512 MiB of f32 rows at dim 32


# --- shard export ------------------------------------------------------------

def _live_slot_index(shard: TableShard) -> torch.Tensor:
    """int32 [n_live] of every live slot, ascending: one nonzero pass, which
    the callers slice into chunks."""
    (idx,) = live_mask(shard).view(-1).nonzero(as_tuple=True)
    return idx.to(torch.int32)


def _fetch_chunk(shard: TableShard, slots: torch.Tensor) -> dict:
    """The rows of live `slots` on the host as CPU tensors of their raw
    types (a bf16 table's values cross to the host as 2-byte rows): the
    4-byte bucket planes gathered in groups of up to 4 planes a launch, the
    values and full-dim planes in one. The copies to the host are
    synchronous, so the arrays are a snapshot when this returns."""
    flat = [p.view(-1, 1) for p in
            (shard.key_hi, shard.key_lo, shard.freq, shard.last, *shard.opt_rowwise[:1])]
    cols = row_gather_multi(flat[:4], slots)
    if flat[4:]:
        cols += row_gather_multi(flat[4:], slots)
    hi, lo, freq, last, *accum = (c.view(-1).cpu() for c in cols)
    vals = table_ops.gather_values_multi((shard.values, *shard.opt_fulldim), slots)
    part = {
        "ids": torch.from_numpy(hashing.join_ids(hi.numpy(), lo.numpy())),
        "values": vals[0].cpu(),
        "freq": freq,
        "last": last,
    }
    if accum:
        part["accum"] = accum[0]
    for j, plane in enumerate(vals[1:]):
        part[f"full{j}"] = plane.cpu()
    return part


def _encode_arrays(arrs: dict) -> dict:
    """npz-storable numpy arrays: bfloat16 tensors ride as their raw uint16
    bits under a `<name>@bf16` key (numpy has no bf16), float64 narrows to
    float32, the rest is stored as it is."""
    out = {}
    for k, a in arrs.items():
        if isinstance(a, torch.Tensor):
            if a.dtype == torch.bfloat16:
                out[f"{k}@bf16"] = a.view(torch.int16).numpy().view(np.uint16)
                continue
            a = a.numpy()
        out[k] = np.asarray(a, np.float32) if a.dtype == np.float64 else a
    return out


def export_shard_arrays(spec: TableSpec, shard: TableShard) -> dict:
    """All live rows of one shard as host numpy arrays, in ascending slot
    order, values and full-dim planes widened to f32 (exactly, from bf16):
    the async save's snapshot and `regrow_shard`'s source. Gathered on the
    device in chunks of `_EXPORT_CHUNK` live slots."""
    n_live = int(shard.cnt.sum())
    if not n_live:
        return _empty_shard_arrays(spec)
    idx = _live_slot_index(shard)[:n_live]
    parts = []
    for o in range(0, n_live, _EXPORT_CHUNK):
        part = _fetch_chunk(shard, idx[o:o + _EXPORT_CHUNK])
        parts.append({k: (v.float() if v.is_floating_point() else v).numpy()
                      for k, v in part.items()})
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _empty_shard_arrays(spec: TableSpec) -> dict:
    out = {
        "ids": np.zeros((0,), np.int64),
        "values": np.zeros((0, spec.dim), np.float32),
        "freq": np.zeros((0,), np.int32),
        "last": np.zeros((0,), np.int32),
    }
    if spec.optimizer.num_rowwise_slots():
        out["accum"] = np.zeros((0,), np.float32)
    for j in range(spec.optimizer.num_fulldim_slots()):
        out[f"full{j}"] = np.zeros((0, spec.dim), np.float32)
    return out


def _part_name(i: int, p: int) -> str:
    return f"shard-{i:05d}.part{p:04d}.npz"


def _counters_name(i: int) -> str:
    # deliberately not matching _shard_files' part glob
    return f"shard-{i:05d}.counters.npy"


def _write_counters_sidecar(gdir: str, i: int, counters) -> None:
    c = counters.cpu().numpy() if isinstance(counters, torch.Tensor) else np.asarray(counters)
    _atomic_write(os.path.join(gdir, _counters_name(i)), lambda f: np.save(f, c))


def _read_counters(gdir: str, num_shards: int):
    """Sum of all shards' counter sidecars, or None when one is missing."""
    total = None
    for i in range(num_shards):
        p = os.path.join(gdir, _counters_name(i))
        if not os.path.exists(p):
            return None
        c = np.load(p)
        total = c if total is None else total + c
    return total


def save_shard_streamed(gdir: str, shard_id: int, spec: TableSpec, shard: TableShard,
                        chunk_rows: int, compress: bool = False) -> int:
    """Write one shard as part files, each `chunk_rows` live rows of the
    ascending live-slot enumeration, committed one by one through atomic
    renames. Re-running the same save (same table state) skips the parts
    that exist without gathering them again, so an interrupted save resumes
    at its first missing part; a part cut from another live count or chunk
    size aborts the resume rather than mixing states. Values (and a bf16
    table's full-dim planes) keep their raw type; `compress=True` deflates
    every part. Stale parts of a higher index are deleted. Returns the live
    row count."""
    n_live = int(shard.cnt.sum())
    expected = -(-n_live // chunk_rows) if n_live else 0
    idx_all = None
    savez = np.savez_compressed if compress else np.savez

    def write(path, arrs, o):
        arrs = _encode_arrays(arrs)
        arrs["n_live"] = np.int64(n_live)
        arrs["chunk_rows"] = np.int64(chunk_rows)
        arrs["row_off"] = np.int64(o)
        _atomic_write(path, lambda f: savez(f, **arrs))

    for p in range(expected):
        path = os.path.join(gdir, _part_name(shard_id, p))
        if os.path.exists(path):
            with np.load(path) as z:
                got = int(z["n_live"])
                # parts cut at another chunk size cover other row ranges
                got_chunk = int(z["chunk_rows"]) if "chunk_rows" in z.files else -1
            if got != n_live or got_chunk != chunk_rows:
                raise RuntimeError(
                    f"resume mismatch: {path} was cut from a table with {got} live rows "
                    f"at chunk_rows={got_chunk}, current save has {n_live} live rows at "
                    f"chunk_rows={chunk_rows}; delete the stale generation dir to start "
                    "a fresh save"
                )
            continue
        if idx_all is None:
            idx_all = _live_slot_index(shard)
        o = p * chunk_rows
        write(path, _fetch_chunk(shard, idx_all[o:min(n_live, o + chunk_rows)]), o)
    if expected == 0:
        # an empty shard writes one empty part: the reader's contract stays uniform
        path = os.path.join(gdir, _part_name(shard_id, 0))
        if not os.path.exists(path):
            write(path, _empty_shard_arrays(spec), 0)
    # leftovers of a higher index would be read as extra rows
    prefix = f"shard-{shard_id:05d}.part"
    for name in os.listdir(gdir):
        if name.startswith(prefix) and name.endswith(".npz"):
            try:
                p = int(name[len(prefix):-4])
            except ValueError:
                continue
            if p >= max(expected, 1):
                os.unlink(os.path.join(gdir, name))
    return n_live


def _atomic_write(path: str, write_fn) -> None:
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-ckpt-")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _gen_name(path: str, step: int) -> str:
    """A fresh generation directory name for this save: never the one the
    committed manifest names (a re-save at the same step gets a .k suffix),
    so the save in flight cannot clobber the live checkpoint."""
    base = f"step-{int(step)}"
    try:
        cur = read_manifest(path).get("dir", "")
    except (FileNotFoundError, json.JSONDecodeError):
        return base
    if cur == base:
        return base + ".1"
    if cur.startswith(base + "."):
        try:
            return f"{base}.{int(cur.rsplit('.', 1)[1]) + 1}"
        except ValueError:
            return base + ".1"
    return base


def _prune_generations(path: str, keep: str) -> None:
    """Remove stale step-* generation directories (crashed or superseded)."""
    for name in os.listdir(path):
        if name.startswith("step-") and name != keep:
            full = os.path.join(path, name)
            if os.path.isdir(full):
                shutil.rmtree(full, ignore_errors=True)


def save(path: str, spec: TableSpec, shards: Sequence[TableShard], step: int,
         extras: Optional[dict] = None, dense: Optional[dict] = None) -> dict:
    """Write a checkpoint directory from a list of shards (`save_sharded`
    with every shard in this process)."""
    return save_sharded(path, spec, dict(enumerate(shards)), len(shards), step,
                        extras=extras, dense=dense)


class AsyncCheckpointer:
    """Saves that return before the files are written. The caller's thread
    takes the snapshot: every shard's live rows and counters copied to host
    memory (`export_shard_arrays`, synchronous copies), and the dense leaves
    copied, so that later steps, which update the planes and the tower in
    place, cannot reach it. A background thread writes the files and
    commits the manifest. At most one save is in flight: `save()` joins the
    previous one first, and `wait()` re-raises a background failure."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None
        self.saves = 0

    def save(self, path: str, spec: TableSpec, shards: Sequence[TableShard], step: int,
             extras: Optional[dict] = None, dense: Optional[dict] = None) -> None:
        self.wait()
        arrs_by_id = {
            i: dict(export_shard_arrays(spec, sh), counters=sh.counters.cpu().numpy().copy())
            for i, sh in enumerate(shards)
        }
        dense_np = {k: [np.array(x) for x in leaves] for k, leaves in (dense or {}).items()}

        def work():
            try:
                save_sharded(path, spec, arrs_by_id, len(arrs_by_id), step,
                             extras=extras, dense=dense_np)
            except BaseException as e:  # surfaced by the next wait() or save()
                self._err = e

        self._thread = threading.Thread(target=work, name="meepo-async-ckpt", daemon=True)
        self._thread.start()
        self.saves += 1

    def wait(self) -> None:
        """Join the save in flight, if any; re-raise its failure."""
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err


def save_sharded(path: str, spec: TableSpec, shards_by_id: dict, num_shards: int, step: int,
                 extras: Optional[dict] = None, dense: Optional[dict] = None,
                 is_coordinator: bool = True, barrier=lambda name="": None) -> dict:
    """The reference's checkpoint protocol. Every process writes the files
    of the shards it holds (streamed parts, or the single-file layout for a
    shard given as exported arrays) and their counters sidecars; the
    coordinator writes the dense leaves ({name: leaves in flatten order},
    the same on every process). Then `barrier("ckpt-shards-written")`; the
    coordinator writes the manifest, the commit point;
    `barrier("ckpt-manifest-committed")`; the coordinator prunes stale
    generations; `barrier("ckpt-pruned")`. Every process returns the
    committed manifest. One process with every shard is its own
    coordinator and needs no barrier."""
    os.makedirs(path, exist_ok=True)
    gen = _gen_name(path, step)
    gdir = os.path.join(path, gen)
    os.makedirs(gdir, exist_ok=True)
    chunk_rows = int(os.environ.get("MEEPO_CKPT_CHUNK_ROWS", 1 << 22))
    compress = os.environ.get("MEEPO_CKPT_COMPRESS", "0") == "1"
    for i, shard in shards_by_id.items():
        if isinstance(shard, dict):
            arrs = dict(shard)
            counters = arrs.pop("counters", None)
            if counters is not None:
                _write_counters_sidecar(gdir, i, counters)
            _atomic_write(os.path.join(gdir, f"shard-{i:05d}.npz"),
                          lambda f, arrs=arrs: np.savez(f, **arrs))
        else:
            save_shard_streamed(gdir, i, spec, shard, chunk_rows, compress=compress)
            _write_counters_sidecar(gdir, i, shard.counters)
    dense = dense or {}
    if is_coordinator:
        for name, leaves in dense.items():
            flat = {f"leaf{j}": np.asarray(x) for j, x in enumerate(leaves)}
            _atomic_write(os.path.join(gdir, f"dense-{name}.npz"),
                          lambda f, flat=flat: np.savez(f, **flat))
    barrier("ckpt-shards-written")
    if is_coordinator:
        manifest = _commit(path, gdir, gen, spec, num_shards, step, sorted(dense), extras)
    barrier("ckpt-manifest-committed")
    if is_coordinator:
        _prune_generations(path, keep=gen)
    barrier("ckpt-pruned")
    return manifest if is_coordinator else read_manifest(path)


def _commit(path: str, gdir: str, gen: str, spec: TableSpec, num_shards: int, step: int,
            dense_names: list, extras: Optional[dict]) -> dict:
    """Count every shard's rows in its files and write the manifest."""
    counts = []
    for i in range(num_shards):
        n = 0
        for f in _shard_files(gdir, i):
            with np.load(f) as z:
                n += int(z["ids"].shape[0])
        counts.append(n)
    manifest = {
        "format": FORMAT_VERSION,
        "num_shards": num_shards,
        "dim": spec.dim,
        "capacity_per_shard": spec.capacity,
        "step": int(step),
        "value_dtype": spec.value_dtype,
        "optimizer": {
            "kind": spec.optimizer.kind,
            "rowwise_slots": spec.optimizer.num_rowwise_slots(),
            "fulldim_slots": spec.optimizer.num_fulldim_slots(),
        },
        "counts": counts,
        "dir": gen,
        "dense": dense_names,
        "extras": extras or {},
    }
    saved_counters = _read_counters(gdir, num_shards)
    if saved_counters is not None:
        manifest["counters"] = [int(x) for x in saved_counters]
    _atomic_write(os.path.join(path, "manifest.json"),
                  lambda f: f.write(json.dumps(manifest, indent=1).encode()))
    return manifest

def save_sharded2d(path: str, spec_local: TableSpec, global_dim: int, shards_by_sc: dict,
                   num_shards: int, num_cols: int, step: int, extras: Optional[dict] = None,
                   dense: Optional[dict] = None, is_coordinator: bool = True,
                   barrier=lambda name="": None) -> dict:
    """Checkpoint a column-sharded table (`parallel/colsharded.py`): each
    (row shard s, column c) given in `shards_by_sc` writes its own lane
    block, `export_shard_arrays` plus `lane_offset` = c * dim / C, to
    shard-SSSSS.colCC.npz; `iter_rows` merges the columns into full-dim
    rows, so the checkpoint restores onto any layout. The same generation
    directory and commit protocol as `save_sharded`; the manifest counts
    the rows of column 0 and records `col_shards`. Like the reference's
    writer it keeps no counters sidecar."""
    os.makedirs(path, exist_ok=True)
    gen = _gen_name(path, step)
    gdir = os.path.join(path, gen)
    os.makedirs(gdir, exist_ok=True)
    for (s, c), shard in shards_by_sc.items():
        arrs = export_shard_arrays(spec_local, shard)
        arrs["lane_offset"] = np.int32(c * spec_local.dim)
        _atomic_write(os.path.join(gdir, f"shard-{s:05d}.col{c:02d}.npz"),
                      lambda f, arrs=arrs: np.savez(f, **arrs))
    dense = dense or {}
    if is_coordinator:
        for name, leaves in dense.items():
            flat = {f"leaf{j}": np.asarray(x) for j, x in enumerate(leaves)}
            _atomic_write(os.path.join(gdir, f"dense-{name}.npz"),
                          lambda f, flat=flat: np.savez(f, **flat))
    barrier("ckpt-shards-written")
    if is_coordinator:
        counts = []
        for i in range(num_shards):
            with np.load(os.path.join(gdir, f"shard-{i:05d}.col00.npz")) as z:
                counts.append(int(z["ids"].shape[0]))
        manifest = {
            "format": FORMAT_VERSION,
            "num_shards": num_shards,
            "col_shards": num_cols,
            "dim": int(global_dim),
            "capacity_per_shard": spec_local.capacity,
            "step": int(step),
            "value_dtype": spec_local.value_dtype,
            "optimizer": {
                "kind": spec_local.optimizer.kind,
                "rowwise_slots": spec_local.optimizer.num_rowwise_slots(),
                "fulldim_slots": spec_local.optimizer.num_fulldim_slots(),
            },
            "counts": counts,
            "dir": gen,
            "dense": sorted(dense),
            "extras": extras or {},
        }
        _atomic_write(os.path.join(path, "manifest.json"),
                      lambda f: f.write(json.dumps(manifest, indent=1).encode()))
    barrier("ckpt-manifest-committed")
    if is_coordinator:
        _prune_generations(path, keep=gen)
    barrier("ckpt-pruned")
    return manifest if is_coordinator else read_manifest(path)


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


def check_manifest(spec: TableSpec, m: dict, lane_slice: Optional[Tuple[int, int]] = None
                   ) -> None:
    """Raise unless a checkpoint's manifest fits `spec` (dim, or the lane
    block `lane_slice` = (off, d) of its rows, and optimizer): the check a
    restore makes before it allocates anything, which callers that drop
    their old planes first make before they drop them."""
    if lane_slice is None:
        if m["dim"] != spec.dim:
            raise ValueError(f"dim mismatch: ckpt {m['dim']} vs spec {spec.dim}")
    else:
        off, d = lane_slice
        if d != spec.dim or off < 0 or off + d > m["dim"]:
            raise ValueError(f"lane block {lane_slice} does not fit ckpt dim {m['dim']} "
                             f"into spec dim {spec.dim}")
    if m["optimizer"]["kind"] != spec.optimizer.kind:
        raise ValueError(
            f"optimizer mismatch: ckpt {m['optimizer']['kind']} vs {spec.optimizer.kind}"
        )


def restore_shards(
    spec: TableSpec, path: str, num_shards: int = 1, batch: int = _RESTORE_BATCH,
    device="cuda", only_ids: Optional[set] = None,
    lane_slice: Optional[Tuple[int, int]] = None,
) -> Tuple[List[Optional[TableShard]], dict]:
    """Rebuild `num_shards` fresh shards on `device` from a checkpoint written
    with any shard count: every saved row is rehashed to its owner shard and
    bulk-inserted. `only_ids` builds only those shards (a process's own in a
    multi-process restore); the others are None. `lane_slice=(off, d)`
    restores lanes [off, off + d) of every saved row into a dim-d spec (one
    column block of a 2-D layout; full-dim optimizer planes are sliced the
    same way, rowwise ones are whole). Raises if any row finds no slot (the
    target capacity is too small), never truncating silently. The saved
    lifetime counters land on shard 0, the restore's own inserts not being
    history; a lane block keeps its own counts, as in the reference."""
    m = read_manifest(path)
    check_manifest(spec, m, lane_slice)
    lanes = slice(None) if lane_slice is None else slice(lane_slice[0], sum(lane_slice))
    if m.get("counts"):
        total = max(1, sum(m["counts"]))
        b = 1024
        while b < min(batch, total):
            b *= 2
        batch = min(batch, b)
    wanted = sorted(range(num_shards) if only_ids is None else only_ids)
    shards = [alloc_shard(spec, device) if s in wanted else None for s in range(num_shards)]
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
            "hi": hi_np, "lo": lo_np, "values": data["values"][:, lanes], "freq": data["freq"],
            "last": data["last"],
        }
        if "accum" in data:
            cols["accum"] = data["accum"]
        for j in range(n_full):
            cols[f"full{j}"] = data[f"full{j}"][:, lanes]
        if len(wanted) < num_shards:  # only this process's rows go to the device
            mine = np.isin(owner, wanted)
            owner = owner[mine]
            cols = {k: v[mine] for k, v in cols.items()}
        on_dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                  for k, v in cols.items()}
        for s in wanted:
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
    if saved is not None and lane_slice is None:
        for s in wanted:
            shard = shards[s]
            shard.counters.zero_()
            if s == 0:
                vals = np.asarray(saved, np.int64)[: shard.counters.shape[0]]
                shard.counters[: len(vals)] = torch.from_numpy(vals.astype(np.int32))
    return shards, m
