"""Dedup formulations timed on one batch of ids (port of the root
`bench_dedup_variants.py`).

    python -m meepoembedding_tpu_torch.bench.dedup_variants [--device cuda|cpu]

The arms, each from (hi, lo) int32 ids to (hi, lo, inverse, valid) of at
most UCAP uniques:

  current  the port's `ops.dedup.unique_pairs`: one stable sort of one
           int64 key, a cumsum of the run starts, the inverse by a
           scatter, the run starts compacted by a scatter.
  B        the reference's variant B: the same, but each unique's first
           position found by a binary search over the sorted run ids
           (`torch.searchsorted`) in place of the compaction scatter.
  library  `torch.unique(key, sorted=True, return_inverse=True)` on the
           same int64 key, the ids read back from the unique keys: the
           library's yardstick.

The reference's variant A (a first sort that carries three operands in
place of five, the ids rebuilt from the sort keys) is what `current`
already does: its one sort carries the key alone and returns the order.
Its variant C (A + B) is therefore B. Neither has an arm of its own.

Every arm's (hi, lo, inverse, valid) is checked equal to current's before
it is timed. Timing: 3 warm-up calls, then STEPS calls between CUDA events
(the host clock on the CPU), ms a call.

Ids are the reference's `make_stream`: N draws of Zipf(1.05) ranks modulo
26,843,545, times 2654435761 plus 12345 (numpy, seed 0), about a third of
them unique at 2^19. Logs the reference's lines on stderr and prints one
JSON line on stdout. Env knobs, the reference's names and defaults: N
(2^19), UCAP (198,784), STEPS (30).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from meepoembedding_tpu_torch.bench._common import (
    device_kind,
    knob,
    log,
    parse_device,
    require,
    start,
    timed,
)
from meepoembedding_tpu_torch.ops import dedup
from meepoembedding_tpu_torch.table import hashing

KEYS = 26843545  # the reference's Zipf key space


def make_stream(n: int, seed: int = 0):
    """The reference's `make_stream`: (hi, lo) int32 numpy arrays."""
    rng = np.random.default_rng(seed)
    ranks = np.minimum(rng.zipf(1.05, size=n).astype(np.int64) % KEYS, KEYS - 1)
    return hashing.split_ids(ranks * 2654435761 + 12345)


def _pad(uh, ul, size: int):
    """The first `size` uniques, the rest the invalid id; and `valid`."""
    m = min(size, uh.shape[0])
    h = torch.full((size,), hashing.EMPTY_HI, dtype=torch.int32, device=uh.device)
    lo = torch.full((size,), hashing.EMPTY_LO, dtype=torch.int32, device=uh.device)
    h[:m], lo[:m] = uh[:m], ul[:m]
    return h, lo, hashing.is_valid(h, lo)


def unique_b(hi, lo, size: int):
    """Variant B: the run starts' positions by a binary search over the
    sorted run ids, in place of the compaction scatter."""
    n = hi.shape[0]
    key = dedup._sort_key(hi, lo)
    skey, order = torch.sort(key, stable=True)
    is_new = torch.ones((n,), dtype=torch.bool, device=hi.device)
    is_new[1:] = skey[1:] != skey[:-1]
    gid0 = torch.cumsum(is_new, 0, dtype=torch.int32) - 1
    gid = gid0.clamp(max=size - 1)
    inverse = torch.empty((n,), dtype=torch.int32, device=hi.device)
    inverse[order] = gid
    pos = torch.searchsorted(gid0, torch.arange(size, dtype=torch.int32, device=hi.device))
    src = order[pos.clamp(max=n - 1)]
    keep = torch.arange(size, device=hi.device) <= gid0[-1]
    uh = torch.where(keep, hi[src], hashing.EMPTY_HI)
    ul = torch.where(keep, lo[src], hashing.EMPTY_LO)
    return uh, ul, inverse, hashing.is_valid(uh, ul)


def unique_library(hi, lo, size: int):
    """`torch.unique` of the int64 sort key, the ids read back from the
    unique keys. The key, ((hi ^ 2^31) - 2^31) * 2^32 + (lo ^ 2^31) of the
    words as unsigned, tells every valid id apart; the invalid id shares
    its key with (2^31 - 1, 0) (as in `current`'s order) and reads back as
    that id. The bench stream holds neither."""
    keys, inverse = torch.unique(dedup._sort_key(hi, lo), sorted=True, return_inverse=True)
    h32 = ((keys >> 32) + 2**31) ^ 0x80000000
    l32 = (keys & hashing.M32) ^ 0x80000000
    uh = (h32 - (h32 >> 31) * 2**32).to(torch.int32)
    ul = (l32 - (l32 >> 31) * 2**32).to(torch.int32)
    uh, ul, valid = _pad(uh, ul, size)
    return uh, ul, inverse.clamp(max=size - 1).to(torch.int32), valid


def run(device="cuda", n=None, ucap=None, steps=None) -> dict:
    """The harness in this process; returns its JSON line's dict. Each
    argument left None reads the reference's environment variable."""
    n = knob(n, "N", 1 << 19)
    ucap = knob(ucap, "UCAP", 198784)
    steps = knob(steps, "STEPS", 30)
    dev = start(device)
    hi_np, lo_np = make_stream(n)
    hi, lo = torch.from_numpy(hi_np).to(dev), torch.from_numpy(lo_np).to(dev)
    log(f"device: {device_kind(dev)}, n={n}, ucap={ucap}")

    def current(h, lo_):
        u = dedup.unique_pairs(h, lo_, ucap)
        return u.hi, u.lo, u.inverse, u.valid

    arms = (("current", current),
            ("B: searchsorted compaction", lambda h, l: unique_b(h, l, ucap)),
            ("library: torch.unique", lambda h, l: unique_library(h, l, ucap)))
    ref = current(hi, lo)
    count = int(ref[3].sum())
    for name, fn in arms[1:]:
        got = fn(hi, lo)
        for what, a, b in zip(("hi", "lo", "inverse", "valid"), got, ref):
            require(torch.equal(a, b), f"variant {name}: {what} differs from current's")
        log(f"variant {name}: correct (U={count})")

    out = {}
    for name, fn in arms:
        for _ in range(3):
            fn(hi, lo)

        def many(fn=fn):
            for _ in range(steps):
                fn(hi, lo)

        ms = timed(dev, many) / steps * 1e3
        out[name] = ms
        log(f"{name:28s} {ms:7.2f} ms")
    return {"metric": "dedup_ms", "device": device_kind(dev), "n": n, "ucap": ucap,
            "unique": count, "steps": steps, "arms": out}


def main() -> None:
    print(json.dumps(run(parse_device(__doc__))), flush=True)


if __name__ == "__main__":
    main()
