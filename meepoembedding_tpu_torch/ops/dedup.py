"""Batch id deduplication with inverse index (port of
`meepoembedding_tpu/ops/dedup.py:20-26,119-189`).

The unique ORDER is the reference's, because insert planning depends on it:
ids sort lexicographically by (hi ^ 0x80000000, lo ^ 0x80000000) as unsigned
words, i.e. by signed hi then signed lo, which is not the order of the int64
id. Invalid ids get the biased hi 0xFFFFFFFF, so they sort last and tie with
a valid id whose hi is 0x7FFFFFFF and lo is 0; that quirk is reproduced.

The two biased words fit one int64 sort key that keeps their order:
((bh - 2^31) << 32) + bl. The reference's TPU workarounds (MXU prefix sums,
sort-based compaction) are plain `cumsum` and a scatter here, with no
host synchronisation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from meepoembedding_tpu_torch.table import hashing


class Unique(NamedTuple):
    hi: torch.Tensor  # i32 [U] unique ids (padded with the invalid sentinel)
    lo: torch.Tensor  # i32 [U]
    inverse: torch.Tensor  # i32 [n] position of each input id in (hi, lo)
    valid: torch.Tensor  # bool [U] slot holds a real unique id
    count: torch.Tensor  # i32 scalar: number of uniques


def _sort_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    inval = ~hashing.is_valid(hi, lo)
    bh = (hi.to(torch.int64) & hashing.M32) ^ 0x80000000
    bh = torch.where(inval, torch.full_like(bh, 0xFFFFFFFF), bh)
    bl = (lo.to(torch.int64) & hashing.M32) ^ 0x80000000
    return (bh - 2**31) * 2**32 + bl


def unique_pairs(hi: torch.Tensor, lo: torch.Tensor, size: int,
                 owner_major: int = 0) -> Unique:
    """Deduplicate id pairs to the static capacity `size`.

    `owner_major=S` makes `hashing.owner_of(id, S)` the primary sort key
    (invalid ids in group S), so the uniques come out grouped by owner shard.
    If the true unique count exceeds `size`, the overflow ids alias the last
    slot, as in the reference."""
    n = hi.shape[0]
    key = _sort_key(hi, lo)
    _, order = torch.sort(key, stable=True)
    if owner_major:
        ow = hashing.owner_of(hi, lo, owner_major)
        ow = torch.where(hashing.is_valid(hi, lo), ow, torch.full_like(ow, owner_major))
        _, o2 = torch.sort(ow[order], stable=True)
        order = order[o2]
    skey, sh, sl = key[order], hi[order], lo[order]
    is_new = torch.ones((n,), dtype=torch.bool, device=hi.device)
    # runs are split by the id key alone (not the owner), as in the reference
    is_new[1:] = skey[1:] != skey[:-1]
    gid0 = torch.cumsum(is_new, 0, dtype=torch.int32) - 1
    num_runs = gid0[-1] + 1
    gid = gid0.clamp(max=size - 1)
    inverse = torch.empty((n,), dtype=torch.int32, device=hi.device)
    inverse[order] = gid
    # compact the run starts (already in id order) into positions gid0; the
    # non-starts all land in the spare slot `width`, which is discarded
    width = max(n, size)
    dest = torch.where(is_new, gid0.long(), torch.full_like(gid0, width, dtype=torch.int64))
    ch = torch.full((width + 1,), hashing.EMPTY_HI, dtype=torch.int32, device=hi.device)
    cl = torch.full((width + 1,), hashing.EMPTY_LO, dtype=torch.int32, device=hi.device)
    ch.scatter_(0, dest, sh)
    cl.scatter_(0, dest, sl)
    keep = torch.arange(size, device=hi.device) < num_runs
    uh = torch.where(keep, ch[:size], hashing.EMPTY_HI)
    ul = torch.where(keep, cl[:size], hashing.EMPTY_LO)
    valid = hashing.is_valid(uh, ul)
    return Unique(hi=uh, lo=ul, inverse=inverse, valid=valid,
                  count=valid.sum().to(torch.int32))
