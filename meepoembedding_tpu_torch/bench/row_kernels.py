"""Row-kernel throughput against the library calls that compute the same
rows (port of the root `bench_pallas.py`): is the port's random row
access as fast as PyTorch's own?

    python -m meepoembedding_tpu_torch.bench.row_kernels [--device cuda|cpu]

At the reference's shapes: a [2^22, 128] f32 plane (2 GiB) and n = 2^19
distinct random rows (`rng.choice(rows, n, replace=False)`, numpy, seed 0).
The plane and the update rows come from a torch generator seeded 0 on the
device, not from the reference's numpy draws: the values do not change the
time. The pairs, each call the reference's `timeit` (a warm-up call, then
STEPS calls, here between CUDA events; the host clock on the CPU):

  torch.index_select rows / row_gather         the reference's jnp.take /
                                               pallas row_gather
  torch.index_add_ unique / row_scatter_add    its XLA .at[].add unique /
    (in place)                                 pallas row_scatter_add (donated)
  torch.index_put_ unique / row_scatter_set    its XLA .at[].set unique (the
                                               reference times no kernel set)
  torch.sort, torch.argsort [512K] i32         its jnp.sort, jnp.argsort
  sort_key + torch.sort 2x[512K] i32           its lexsort of two int32 keys:
                                               the port's dedup sorts one
                                               int64 key (`ops.dedup._sort_key`)

Each kernel's rows are checked equal to its library call's before anything
is timed. The adds and sets run in place on the one plane, as the
reference's donated arm; the library adds too (the reference's XLA add
copied the plane).

Prints the reference's lines on stderr (label, ms, GB/s with the
reference's byte counts: rows moved once for a gather or a set, three
times for an add) and one JSON line on stdout: each call's label, the
reference's label, ms, the reference's bytes and GB/s, and the bytes a call
must move at least (each input read once, each output written once) with
their time at 3.35 TB/s (`bound_ms`, an H100 SXM).

The command runs at the reference's fixed shapes; `run(rows=, n=, steps=)`
takes smaller ones (plane rows, rows a call, timed calls).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from meepoembedding_tpu_torch.bench._common import (
    device_kind,
    log,
    parse_device,
    require,
    start,
    timed,
)
from meepoembedding_tpu_torch.kernels import row_gather, row_scatter_add, row_scatter_set
from meepoembedding_tpu_torch.ops import dedup

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
LANES = 128

# (the port's label, the reference's label); the reference has no kernel set
LABELS = (
    ("torch.index_select rows", "jnp.take rows"),
    ("row_gather", "pallas row_gather"),
    ("torch.index_add_ unique", "XLA .at[].add unique"),
    ("torch.index_put_ unique", "XLA .at[].set unique"),
    ("row_scatter_set", None),
    ("row_scatter_add (in place)", "pallas row_scatter_add (donated)"),
    ("torch.sort [512K] i32", "jnp.sort [512K] i32"),
    ("torch.argsort [512K] i32", "jnp.argsort [512K] i32"),
    ("sort_key + torch.sort 2x[512K] i32", "lexsort 2x[512K] i32"),
)


def run(device="cuda", rows=None, n=None, steps=None) -> dict:
    """The harness in this process; returns its JSON line's dict. Each
    argument left None takes the reference's value: a 2^22-row plane,
    n = 2^19, 20 timed calls."""
    R = rows if rows is not None else 1 << 22
    n = n if n is not None else 1 << 19
    steps = steps if steps is not None else 20
    dev = start(device)
    rng = np.random.default_rng(0)
    g = torch.Generator(device=dev).manual_seed(0)
    plane = torch.randn((R, LANES), generator=g, device=dev)
    idx = torch.from_numpy(rng.choice(R, size=n, replace=False).astype(np.int32)).to(dev)
    upd = torch.randn((n, LANES), generator=g, device=dev)
    big = torch.from_numpy(rng.integers(0, 2**31, size=n, dtype=np.int32)).to(dev)
    pair = torch.from_numpy(rng.integers(0, 2**31, size=n, dtype=np.int32)).to(dev)
    moved = n * LANES * 4
    log(f"plane [{R},128] f32 = {R * 512 / 1e9:.1f} GB; n={n}")

    # each kernel against its library call, on copies where the plane changes
    require(torch.equal(row_gather(plane, idx), torch.index_select(plane, 0, idx)),
            "row_gather disagrees with torch.index_select")
    for name, kernel, library in (
            ("row_scatter_add", lambda p: row_scatter_add(p, idx, upd),
             lambda p: p.index_add_(0, idx, upd)),
            ("row_scatter_set", lambda p: row_scatter_set(p, idx, upd),
             lambda p: p.index_put_((idx,), upd))):
        a = kernel(plane.clone())
        require(torch.equal(a, library(plane.clone())),
                f"{name} disagrees with its library call")
        del a

    rows_io = 2 * moved + 4 * n  # rows read and written, int32 indices
    calls = (  # (fn, the reference's bytes, the least bytes a call moves)
        (lambda: torch.index_select(plane, 0, idx), moved, rows_io),
        (lambda: row_gather(plane, idx), moved, rows_io),
        (lambda: plane.index_add_(0, idx, upd), 3 * moved, moved + rows_io),
        (lambda: plane.index_put_((idx,), upd), moved, rows_io),
        (lambda: row_scatter_set(plane, idx, upd), moved, rows_io),
        (lambda: row_scatter_add(plane, idx, upd), 3 * moved, moved + rows_io),
        (lambda: torch.sort(big), None, 16 * n),  # values and int64 indices out
        (lambda: torch.argsort(big), None, 12 * n),
        (lambda: torch.sort(dedup._sort_key(big, pair), stable=True), None, 24 * n),
    )
    out = []
    for (label, ref), (fn, ref_bytes, nbytes) in zip(LABELS, calls):
        fn()

        def many(fn=fn):
            for _ in range(steps):
                fn()

        dt = timed(dev, many) / steps
        gbps = ref_bytes / dt / 1e9 if ref_bytes else None
        log(f"{label:40s} {dt * 1e3:9.3f} ms" + (f"  {gbps:8.1f} GB/s" if gbps else ""))
        out.append({"label": label, "reference": ref, "ms": dt * 1e3, "ref_bytes": ref_bytes,
                    "gbps": gbps, "bytes": nbytes,
                    "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
    return {"metric": "row_kernel_ms", "device": device_kind(dev), "rows": R, "n": n,
            "steps": steps, "calls": out}


def main() -> None:
    print(json.dumps(run(parse_device(__doc__))), flush=True)


if __name__ == "__main__":
    main()
