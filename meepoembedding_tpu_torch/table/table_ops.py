"""Table storage ops on tensors (port of the serving-path subset of
`meepoembedding_tpu/table/xla_ops.py`).

  probe              XOR pair-probing: one row gather per two rounds of each
                     key plane, viewed as [nb/2, 256] bucket pairs.
  plan_insert        collision-free free-lane assignment for missed keys,
                     round by round, with the reference's exact slot choice.
  insert_rows        bulk upsert (restore, `table.assign`): probe, plan, then
                     row sets into every plane, in place.
  lookup_rows        found-row gather from the values plane.

Every row gather goes through `kernels.row_gather` and every write of the
restore path through `kernels.row_scatter_set`; on CPU tensors those take
their plain versions. Shards are updated in place.

The reference writes with `mode="drop"` scatters whose dropped entries carry
the index `len`; PyTorch has no such mode, so the small [nb] count updates
here index a buffer one longer and discard its last element. Where the
reference branches with `lax.cond` on a device flag, this code branches in
Python on `.any()`, a host synchronisation that the insert path can afford
and the lookup path never takes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from meepoembedding_tpu_torch.config import LANES
from meepoembedding_tpu_torch.kernels import row_gather, row_scatter_set
from meepoembedding_tpu_torch.table import hashing
from meepoembedding_tpu_torch.table.layout import INSERTS, TableShard, TableSpec


class ProbeResult(NamedTuple):
    slot: torch.Tensor  # i32 [n], -1 if not found
    found: torch.Tensor  # bool [n]


class InsertPlan(NamedTuple):
    slot: torch.Tensor  # i32 [n], -1 if dropped/not wanted
    ok: torch.Tensor  # bool [n]
    cnt: torch.Tensor  # updated [nb]
    ovf: torch.Tensor  # updated [nb]


def _first_true(m: torch.Tensor) -> torch.Tensor:
    """Per row, the first True lane of a [n, 128] mask (0 if none), as the
    reference's `argmax` over booleans gives it."""
    return torch.argmax(m.to(torch.uint8), dim=1).to(torch.int32)


def probe(spec: TableSpec, shard: TableShard, uh, ul, valid) -> ProbeResult:
    """Find the slots of (deduped) keys in `max_probe_rounds` rounds of
    bucketized XOR probing (b0 ^ r). Rounds 2g and 2g+1 share one aligned
    bucket pair, so one [n, 256] gather of each key plane serves two rounds."""
    nb = spec.num_buckets
    b0 = hashing.bucket_of(uh, ul, nb)
    n = uh.shape[0]
    rounds = min(spec.max_probe_rounds, nb)
    slot = torch.full((n,), -1, dtype=torch.int32, device=uh.device)
    found = torch.zeros((n,), dtype=torch.bool, device=uh.device)
    if nb == 1:
        m = (shard.key_hi[0][None, :] == uh[:, None]) & (shard.key_lo[0][None, :] == ul[:, None])
        hit = m.any(dim=1) & valid
        return ProbeResult(torch.where(hit, _first_true(m), -1), hit)
    hi_pair = shard.key_hi.view(nb // 2, 2 * LANES)
    lo_pair = shard.key_lo.view(nb // 2, 2 * LANES)
    p0 = b0 >> 1
    uh_c, ul_c = uh[:, None], ul[:, None]
    for g in range((rounds + 1) // 2):
        # an odd `rounds` probes one extra bucket: harmless, nothing is ever
        # stored beyond a key's insert rounds
        pg = p0 ^ g
        row_h = row_gather(hi_pair, pg)
        row_l = row_gather(lo_pair, pg)
        m_e = (row_h[:, :LANES] == uh_c) & (row_l[:, :LANES] == ul_c)
        m_o = (row_h[:, LANES:] == uh_c) & (row_l[:, LANES:] == ul_c)
        hit_e = m_e.any(dim=1) & valid
        hit_o = m_o.any(dim=1) & valid
        slot_g = torch.where(hit_e, pg * (2 * LANES) + _first_true(m_e),
                             (pg * 2 + 1) * LANES + _first_true(m_o))
        hit = hit_e | hit_o
        slot = torch.where(hit & ~found, slot_g, slot)
        found = found | hit
    return ProbeResult(slot=slot, found=found)


def _segmented_rank(sort_key: torch.Tensor):
    """(order, rank within equal keys in sorted order), stable."""
    n = sort_key.shape[0]
    _, order = torch.sort(sort_key, stable=True)
    ks = sort_key[order]
    idx = torch.arange(n, dtype=torch.int64, device=sort_key.device)
    is_start = torch.ones((n,), dtype=torch.bool, device=sort_key.device)
    is_start[1:] = ks[1:] != ks[:-1]
    seg_first = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    return order, (idx - seg_first).to(torch.int32)


def _plan_insert_impl(spec: TableSpec, shard: TableShard, uh, ul, want):
    nb = spec.num_buckets
    n = uh.shape[0]
    dev = uh.device
    b0 = hashing.bucket_of(uh, ul, nb)
    pending = want
    slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    # [nb + 1] buffers: index nb receives the entries the reference drops
    cnt = torch.cat([shard.cnt, shard.cnt.new_zeros(1)])
    ovf = torch.cat([shard.ovf, shard.ovf.new_zeros(1)])
    claimed = torch.zeros((nb + 1,), dtype=torch.int32, device=dev)
    ones = torch.ones((n,), dtype=torch.int32, device=dev)
    for r in range(min(spec.max_probe_rounds, nb)):
        if not bool(pending.any()):
            break  # the reference's untaken lax.cond: nothing changes any more
        b = b0 ^ r
        sort_key = torch.where(pending, b, nb)
        order, rank_sorted = _segmented_rank(sort_key)
        rank = torch.empty_like(rank_sorted)
        rank[order] = rank_sorted
        # the bucket's free lanes, in lane order, from the planes as they were
        # before this call (the `claimed` tally accounts for this call's picks)
        kh = row_gather(shard.key_hi, b)
        kl = row_gather(shard.key_lo, b)
        free = (kh == hashing.EMPTY_HI) & (kl == hashing.EMPTY_LO)
        cum = torch.cumsum(free, dim=1, dtype=torch.int32)
        num_free = cum[:, -1]
        eff_rank = rank + claimed[b.long()]
        islane = free & (cum == (eff_rank + 1).clamp(1, LANES)[:, None])
        lane = _first_true(islane)
        ok = pending & (eff_rank < num_free)
        fail = pending & ~ok
        slot = torch.where(ok, b * LANES + lane, slot)
        at_ok = torch.where(ok, b, nb).long()
        claimed.index_add_(0, at_ok, ones)
        cnt.index_add_(0, at_ok, ones)
        ovf.scatter_reduce_(0, torch.where(fail, b, nb).long(), ones, reduce="amax")
        pending = fail
    return slot, cnt[:nb], ovf[:nb]


def plan_insert(spec: TableSpec, shard: TableShard, uh, ul, want) -> InsertPlan:
    """Assign a free (bucket, lane) to each wanted key, collision-free within
    the batch: keys of one bucket take its free lanes in rank order, and a
    per-bucket `claimed` tally carries the picks across rounds.

    `spec.insert_cap` bounds the admitted inserts of one call: the first
    `insert_cap` wanted keys are planned, the rest get slot -1."""
    n = uh.shape[0]
    C = spec.insert_cap
    if C is None or C >= n:
        slot, cnt, ovf = _plan_insert_impl(spec, shard, uh, ul, want)
        return InsertPlan(slot=slot, ok=want & (slot >= 0), cnt=cnt, ovf=ovf)
    if not bool(want.any()):
        slot = torch.full((n,), -1, dtype=torch.int32, device=uh.device)
        return InsertPlan(slot=slot, ok=want & (slot >= 0), cnt=shard.cnt.clone(),
                          ovf=shard.ovf.clone())
    (cidx,) = want.nonzero(as_tuple=True)
    cidx = cidx[:C]
    sel = torch.zeros((C,), dtype=torch.bool, device=uh.device)
    sel[: cidx.shape[0]] = True
    ci = torch.full((C,), n - 1, dtype=torch.int64, device=uh.device)
    ci[: cidx.shape[0]] = cidx
    slot_c, cnt, ovf = _plan_insert_impl(spec, shard, uh[ci], ul[ci], sel)
    slot = torch.full((n,), -1, dtype=torch.int32, device=uh.device)
    slot[cidx] = slot_c[: cidx.shape[0]]
    return InsertPlan(slot=slot, ok=want & (slot >= 0), cnt=cnt, ovf=ovf)


def gather_values(plane: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """[n] slots -> [n, dim] rows of a row-major value plane. Slots < 0 read
    row 0; the caller masks them."""
    return row_gather(plane, slot.clamp(min=0))


def lookup_rows(shard: TableShard, slot: torch.Tensor) -> torch.Tensor:
    """[n] slots -> [n, dim] embedding rows; slots < 0 -> zero rows."""
    rows = gather_values(shard.values, slot)
    return rows.masked_fill_((slot < 0)[:, None], 0)


def scatter_bucket_plane(plane: torch.Tensor, slot, val, enabled) -> None:
    """plane[slot // 128, slot % 128] = val where enabled, in place, for a
    [nb, 128] plane: one element set on its flat [nb * 128, 1] view
    (enabled slots are unique)."""
    val = torch.as_tensor(val, device=slot.device).to(plane.dtype).expand(slot.shape)
    idx = torch.where(enabled, slot, -1).to(torch.int32)
    row_scatter_set(plane.view(-1, 1), idx, val.reshape(-1, 1).contiguous())


def scatter_set_values(plane: torch.Tensor, slot, rows, enabled) -> None:
    """plane[slot] = rows where enabled, in place: whole rows of a row-major
    value plane."""
    idx = torch.where(enabled, slot, -1).to(torch.int32)
    row_scatter_set(plane, idx, rows.to(plane.dtype).contiguous())


def insert_rows(
    spec: TableSpec, shard: TableShard, hi, lo, rows, valid, step: int,
    freq=None, accum=None, fulldim: Optional[Sequence[torch.Tensor]] = None,
    last=None,
) -> torch.Tensor:
    """Bulk insert/overwrite of explicit rows (restore, `table.assign`), in
    place. Existing keys are overwritten; optimizer state is set from
    `accum`/`fulldim` when given, else reset to fresh-row defaults; `last`
    defaults to `step`. Returns the [n] bool mask of rows that landed."""
    pr = probe(spec, shard, hi, lo, valid)
    plan = plan_insert(spec, shard, hi, lo, valid & ~pr.found)
    slot = torch.where(pr.found, pr.slot, plan.slot)
    ok = valid & (slot >= 0)
    fresh = ok & ~pr.found

    scatter_bucket_plane(shard.key_hi, slot, hi, fresh)
    scatter_bucket_plane(shard.key_lo, slot, lo, fresh)
    scatter_set_values(shard.values, slot, rows, ok)
    scatter_bucket_plane(shard.freq, slot, 1 if freq is None else freq, ok)
    scatter_bucket_plane(shard.last, slot, step if last is None else last, ok)
    if shard.opt_rowwise:
        a = spec.optimizer.initial_accumulator if accum is None else accum
        scatter_bucket_plane(shard.opt_rowwise[0], slot, a, ok)
    for j, plane in enumerate(shard.opt_fulldim):
        scatter_set_values(plane, slot, torch.zeros_like(rows) if fulldim is None
                           else fulldim[j], ok)
    shard.cnt.copy_(plan.cnt)
    shard.ovf.copy_(plan.ovf)
    shard.counters[INSERTS] += fresh.sum().to(torch.int32)
    return ok
