"""Batch id deduplication with inverse index, and its backward (port of
`meepoembedding_tpu/ops/dedup.py:20-26,119-206`).

The unique ORDER is the reference's, because insert planning depends on it:
ids sort lexicographically by (hi ^ 0x80000000, lo ^ 0x80000000) as unsigned
words, i.e. by signed hi then signed lo, which is not the order of the int64
id. Invalid ids get the biased hi 0xFFFFFFFF, so they sort last and tie with
a valid id whose hi is 0x7FFFFFFF and lo is 0; that quirk is reproduced.

The two biased words fit one int64 sort key that keeps their order:
((bh - 2^31) << 32) + bl. The reference's TPU workarounds (MXU prefix sums,
sort-based compaction) are plain `cumsum` and a scatter here, with no
host synchronisation.

The backward of the gather by `inverse` is a segment sum of the
per-occurrence gradients into the unique rows: K1's `kernels.segment_sum`
into a zeroed [U, dim] plane, the same bits on every launch. It needs the ids sorted by unique row, which `unique_pairs` has
already computed: it returns its stable permutation `order` and the sorted
run ids `sorted_ids`, and `GatherRows` hands them to the backward, so the
training step sorts once. The plane is zeroed by a memset before the kernel
writes the runs' sums: the rows past the unique count (most of a [U, dim]
plane padded to the batch) must read zero, and a memset writes them at the
copy rate.

Not in the reference: with ragged multi-hot bags (`pooling.Bags`), the
gather pools. Forward, each bag's row is the sum of its ids' unique rows
(K1's segment sum reading the rows through `inverse`, the bags' positions in
order), then the combiner (`pooling.pool_bags`): [B * S, dim], an empty bag
zeros. Backward, the pooled gradient scaled as the combiner scales goes
to the unique rows by the same segment sum over the dedup's sorted ids,
each reading its bag's row. No [n, dim] rows are made either way.

With positional ragged bags (`pooling.Positions`, the bags of a model that
pools inside) the gather lays the rows out by place. Forward, each valid
id's unique row goes to its (b, s, slot) place of a zero [B * S * L, dim]
output: the same segment sum, whose runs are the places (increasing, one id
each) and whose rows are read through `inverse`. Backward, the segment sum
over the dedup's sorted ids, each reading the gradient at its id's place:
the padding's places are never read.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from meepoembedding_tpu_torch.kernels import row_gather, segment_sum, segment_sum_gather
from meepoembedding_tpu_torch.ops import pooling
from meepoembedding_tpu_torch.table import hashing
from meepoembedding_tpu_torch.tracing import span


class Unique(NamedTuple):
    hi: torch.Tensor  # i32 [U] unique ids (padded with the invalid sentinel)
    lo: torch.Tensor  # i32 [U]
    inverse: torch.Tensor  # i32 [n] position of each input id in (hi, lo)
    valid: torch.Tensor  # bool [U] slot holds a real unique id
    count: torch.Tensor  # i32 scalar: number of uniques
    # not in the reference: the dedup's own stable sort, for the backward
    order: torch.Tensor  # i64 [n] input position of each sorted position
    sorted_ids: torch.Tensor  # i32 [n] inverse[order], non-decreasing


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
    slot, as in the reference.

    `order` and `sorted_ids` are the sort this computes: `inverse[order] ==
    sorted_ids`, non-decreasing. Without overflow `order` is the stable sort
    of `inverse` (with `owner_major` too: equal ids share an owner). With
    overflow the aliased ids share the last run in id order, not in input
    order: still a fixed order."""
    with span("meepo.table.dedup"):
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
                      count=valid.sum().to(torch.int32), order=order, sorted_ids=gid)


def segment_sum_grads(grads: torch.Tensor, inverse: torch.Tensor, num_unique: int,
                      order: Optional[torch.Tensor] = None,
                      sorted_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[n, dim] per-occurrence grads -> [U, dim] f32 per-unique-id grads.
    Entries of `inverse` outside [0, U) are dropped. `order` and
    `sorted_ids` (from `unique_pairs`) spare the kernel its sort."""
    return segment_sum(grads.float().contiguous(), inverse, num_unique,
                       order=order, sorted_rows=sorted_ids)


def place_rows(rows_u: torch.Tensor, inverse: torch.Tensor,
               positions: pooling.Positions) -> torch.Tensor:
    """The forward of `GatherRows` with `pooling.Positions`: each valid id's
    unique row rows_u[inverse[k]] at its place positions.at[k] of a zero
    [B * S * L, dim] f32 output (K1's segment sum, one run a place). A
    scoring request, which needs no gradient, calls it directly."""
    with span("meepo.table.positions"):
        return segment_sum_gather(rows_u.float().contiguous(), inverse.long(), positions.at,
                                  positions.valid.numel())


def _sort(inverse: torch.Tensor):
    """(order, sorted ids) of the stable sort of `inverse`, as `Unique`
    holds them."""
    sorted_ids, order = torch.sort(inverse, stable=True)
    return order, sorted_ids


class GatherRows(torch.autograd.Function):
    """rows_u[inverse]: the unique rows expanded to batch order (K2), whose
    gradient is the segment sum of the batch-order gradients (K1). This is
    how the model's gradient reaches the unique rows of a training step.
    `order` and `sorted_ids` (the `Unique`'s) let the backward skip its
    sort. With `bags` (`pooling.Bags` of ragged ids) the rows come out
    pooled, [B * S, dim], and the gradient goes back through the pooling;
    with `pooling.Positions` they come out at their places, [B * S * L,
    dim], zero under padding."""

    @staticmethod
    def forward(ctx, rows_u: torch.Tensor, inverse: torch.Tensor,
                order: Optional[torch.Tensor] = None,
                sorted_ids: Optional[torch.Tensor] = None,
                bags=None) -> torch.Tensor:
        sort = () if order is None else (order, sorted_ids)
        ctx.num_unique = rows_u.shape[0]
        ctx.kind = None if bags is None else type(bags)
        if bags is None:
            ctx.save_for_backward(inverse, *sort)
            with span("meepo.table.gather"):
                return row_gather(rows_u.contiguous(), inverse)
        if isinstance(bags, pooling.Positions):
            ctx.save_for_backward(inverse, bags.at, *sort)
            return place_rows(rows_u, inverse, bags)
        ctx.save_for_backward(inverse, bags.of, bags.lengths, *sort)
        ctx.combiner = bags.combiner
        with span("meepo.table.pool"):
            B, S = bags.lengths.shape
            sums = segment_sum_gather(rows_u.float().contiguous(), inverse.long(), bags.of,
                                      B * S)
            return pooling.pool_bags(sums.view(B, S, 1, -1), bags.lengths,
                                     bags.combiner).reshape(B * S, -1)

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        if ctx.kind is None:
            inverse, *sort = ctx.saved_tensors
            with span("meepo.table.segment_sum"):
                g = segment_sum_grads(grad_out, inverse, ctx.num_unique, *sort)
            return g, None, None, None, None
        if ctx.kind is pooling.Positions:
            inverse, at, *sort = ctx.saved_tensors
            with span("meepo.table.positions_backward"):
                order, sorted_ids = sort if sort else _sort(inverse)
                g = segment_sum_gather(grad_out.float().contiguous(),
                                       at.long().index_select(0, order), sorted_ids,
                                       ctx.num_unique)
            return g, None, None, None, None
        inverse, of, lengths, *sort = ctx.saved_tensors
        with span("meepo.table.pool_backward"):
            order, sorted_ids = sort if sort else _sort(inverse)
            g = pooling.combine(grad_out.reshape(-1, grad_out.shape[-1]).float(),
                                pooling.bag_counts(lengths).reshape(-1),
                                ctx.combiner).contiguous()
            bag_of_sorted = of.long().index_select(0, order)
            g = segment_sum_gather(g, bag_of_sorted, sorted_ids, ctx.num_unique)
        return g, None, None, None, None
