"""Table storage ops on tensors (port of `meepoembedding_tpu/table/xla_ops.py`:
the serving, training and lifecycle paths).

  probe              XOR pair-probing through `kernels.bucket_probe`: the
                     hash, every round and the first-lane match in one
                     launch on the card.
  plan_insert        collision-free free-lane assignment for missed keys,
                     round by round, with the reference's exact slot choice.
  insert_rows        bulk upsert (restore, `table.assign`): probe, plan, then
                     row sets into every plane, in place.
  lookup_rows        found-row gather from the values plane.
  lookup_probe       the probe-only read: probe, then one gather of the
                     found rows (zero rows for absent and invalid keys).
  cms_admit          count-min-sketch frequency admission.
  lookup_train       the training lookup: probe, admission, insert planning
                     and the side-plane writes of fresh keys, with the rows
                     of every unique id (fresh ids: their init) and no write
                     to the values plane.
  evict_pass         LFU/TTL eviction over a rotating window of buckets,
                     exporting the evicted rows for the spill tier.
  erase_keys         explicit key removal.
  check_invariants   the debug scan of a shard's invariants.

Every probe goes through `kernels.bucket_probe`, every row gather through
`kernels.row_gather_multi` and every row set through
`kernels.row_scatter_set_multi` (the planes that share an index in one
launch), every bucket-plane add through `kernels.row_scatter_add` (a
fetch-add where the caller needs the old values) and every values-plane add
through `kernels.row_merge_add` on unique rows; on CPU tensors those take
their plain versions. Shards are updated in place.

The reference writes with `mode="drop"` scatters whose dropped entries carry
the index `len`; PyTorch has no such mode, so the small [nb] count updates
here index a buffer one longer and discard its last element. Where the
reference branches with `lax.cond` on a device flag, this code branches in
Python on `.any()`, a host synchronisation that the insert path can afford
and the lookup path never takes.
"""

from __future__ import annotations

import numbers
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from meepoembedding_tpu_torch.config import LANES
from meepoembedding_tpu_torch.kernels import (
    bucket_probe,
    row_gather_multi,
    row_merge_add,
    row_scatter_add,
    row_scatter_set_multi,
)
from meepoembedding_tpu_torch.kernels.bucket_probe import first_true
from meepoembedding_tpu_torch.table import hashing
from meepoembedding_tpu_torch.table.layout import (
    DENIED,
    DROPS,
    ERASES,
    EVICTIONS,
    HITS,
    INSERTS,
    MISSES,
    TableShard,
    TableSpec,
)
from meepoembedding_tpu_torch.tracing import span, spanned


class ProbeResult(NamedTuple):
    slot: torch.Tensor  # i32 [n], -1 if not found
    found: torch.Tensor  # bool [n]


class InsertPlan(NamedTuple):
    slot: torch.Tensor  # i32 [n], -1 if dropped/not wanted
    ok: torch.Tensor  # bool [n]
    cnt: torch.Tensor  # updated [nb]
    ovf: torch.Tensor  # updated [nb]


@spanned("meepo.table.probe")
def probe(spec: TableSpec, shard: TableShard, uh, ul, valid) -> ProbeResult:
    """Find the slots of (deduped) keys in `max_probe_rounds` rounds of
    bucketized XOR probing (b0 ^ r): one `bucket_probe` call, the hash,
    every round and the first-lane match in one launch on the card."""
    slot, found = bucket_probe(shard.key_hi, shard.key_lo, uh, ul, valid,
                               spec.max_probe_rounds)
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
        with span("meepo.table.plan_sync"):
            if not bool(pending.any()):
                break  # the reference's untaken lax.cond: nothing changes any more
        with span("meepo.table.plan_round"):
            b = b0 ^ r
            sort_key = torch.where(pending, b, nb)
            order, rank_sorted = _segmented_rank(sort_key)
            rank = torch.empty_like(rank_sorted)
            rank[order] = rank_sorted
            # the bucket's free lanes, in lane order, from the planes as they
            # were before this call (the `claimed` tally accounts for this
            # call's picks)
            kh, kl = row_gather_multi((shard.key_hi, shard.key_lo), b)
            free = (kh == hashing.EMPTY_HI) & (kl == hashing.EMPTY_LO)
            cum = torch.cumsum(free, dim=1, dtype=torch.int32)
            num_free = cum[:, -1]
            eff_rank = rank + claimed[b.long()]
            islane = free & (cum == (eff_rank + 1).clamp(1, LANES)[:, None])
            lane = first_true(islane)
            ok = pending & (eff_rank < num_free)
            fail = pending & ~ok
            slot = torch.where(ok, b * LANES + lane, slot)
            at_ok = torch.where(ok, b, nb).long()
            claimed.index_add_(0, at_ok, ones)
            cnt.index_add_(0, at_ok, ones)
            ovf.scatter_reduce_(0, torch.where(fail, b, nb).long(), ones, reduce="amax")
            pending = fail
    return slot, cnt[:nb], ovf[:nb]


@spanned("meepo.table.plan")
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
    with span("meepo.table.plan_sync"):
        none_wanted = not bool(want.any())
    if none_wanted:
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


def gather_values_multi(planes: Sequence[torch.Tensor], slot: torch.Tensor) -> list:
    """[n] slots -> [n, dim] rows of each of up to 4 row-major planes of one
    shape (the values plane, full-dim optimizer state), in one launch. Slots
    < 0 read row 0; the caller masks them."""
    return row_gather_multi(planes, slot.clamp(min=0))


def gather_values(plane: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """`gather_values_multi` of one plane."""
    return gather_values_multi((plane,), slot)[0]


def lookup_rows(shard: TableShard, slot: torch.Tensor) -> torch.Tensor:
    """[n] slots -> [n, dim] embedding rows; slots < 0 -> zero rows."""
    rows = gather_values(shard.values, slot)
    return rows.masked_fill_((slot < 0)[:, None], 0)


def lookup_probe(spec: TableSpec, shard: TableShard, uh, ul, valid,
                 order: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ProbeResult]:
    """Probe-only read of (deduped) keys, inserting nothing: (rows [n, dim]
    in the table's type, the probe). Absent and invalid keys read zero rows,
    since the probe gives them slot -1. With `order` ([m] indices into the
    keys) the rows are those of keys[order], in one gather all the same."""
    pr = probe(spec, shard, uh, ul, valid)
    with span("meepo.table.gather"):
        rows = lookup_rows(shard, pr.slot if order is None else pr.slot[order.long()])
    return rows, pr


def set_index(slot: torch.Tensor, enabled: torch.Tensor) -> torch.Tensor:
    """The int32 index of a set: slot where enabled, else -1 (dropped)."""
    return torch.where(enabled, slot, -1).to(torch.int32)


def scatter_bucket_planes(idx: torch.Tensor, writes: Sequence[tuple]) -> None:
    """plane[slot // 128, slot % 128] = val for each (plane, val) of
    `writes`, in place, where `idx` (from `set_index`) holds the slot: one
    element set on each [nb, 128] plane's flat [nb * 128, 1] view, all the
    planes in one launch (enabled slots are unique). `val` is a Python
    number, whose bits the kernel takes, or a tensor of [n] values."""
    n = idx.shape[0]
    row_scatter_set_multi(
        [p.view(-1, 1) for p, _ in writes], idx,
        [v if isinstance(v, numbers.Number) else
         torch.as_tensor(v, device=idx.device).to(p.dtype).expand(n).reshape(n, 1).contiguous()
         for p, v in writes])


def scatter_set_values(idx: torch.Tensor, writes: Sequence[tuple]) -> None:
    """plane[slot] = rows for each (plane, rows) of `writes`, in place,
    where `idx` (from `set_index`) holds the slot: whole rows of row-major
    value planes of one shape and type, in one launch. `rows` is an
    [n, dim] tensor, or a Python number for every row."""
    row_scatter_set_multi(
        [p for p, _ in writes], idx,
        [v if isinstance(v, numbers.Number) else v.to(p.dtype).contiguous()
         for p, v in writes])


def scatter_add_bucket_plane(plane: torch.Tensor, slot, val, enabled,
                             old: Optional[torch.Tensor] = None) -> None:
    """plane[slot // 128, slot % 128] += val where enabled, in place, for a
    [nb, 128] int32 (wrapping) or f32 plane: one element add on its flat
    [nb * 128, 1] view (enabled slots are unique). `old` ([n, 1], the
    plane's type), when given, receives each enabled slot's value from
    before the add, 0 elsewhere, in the same launch."""
    val = torch.as_tensor(val, device=slot.device).to(plane.dtype).expand(slot.shape)
    row_scatter_add(plane.view(-1, 1), set_index(slot, enabled),
                    val.reshape(-1, 1).contiguous(), old)


def fetch_add_bucket_plane(plane: torch.Tensor, slot, val, enabled) -> torch.Tensor:
    """`scatter_add_bucket_plane` that also returns the [n] values from
    before the add: the old value where enabled, 0 elsewhere (the
    reference's `gather_bucket_plane` read slot 0 there; no caller uses the
    values of slots it does not update)."""
    old = torch.empty((slot.shape[0], 1), dtype=plane.dtype, device=slot.device)
    scatter_add_bucket_plane(plane, slot, val, enabled, old)
    return old.view(-1)


def scatter_add_values(plane: torch.Tensor, slot, rows, enabled) -> None:
    """plane[slot] += rows where enabled, in place, for the row-major values
    plane or a full-dim optimizer plane like it: whole rows, summed in f32
    and rounded once (the reference's `values_scatter_add`).

    The enabled slots must be unique: `row_merge_add` is the unique-row
    add, where duplicates would race. Every caller meets
    this. Its slots are one per unique id of a `unique_pairs` dedup, from
    `lookup_train` (or `probe` and `plan_insert`): two distinct keys never
    share a slot, and `plan_insert` gives each admitted key a free lane of
    its own, never one that is taken."""
    row_merge_add(plane, set_index(slot, enabled), rows.float().contiguous())


def touch(shard: TableShard, slot, enabled, step: int) -> None:
    """Record hits in place: freq += 1, last = step."""
    scatter_add_bucket_plane(shard.freq, slot, 1, enabled)
    scatter_bucket_planes(set_index(slot, enabled), [(shard.last, step)])


@spanned("meepo.table.admit")
def cms_admit(spec: TableSpec, cms: torch.Tensor, uh, ul, miss) -> torch.Tensor:
    """Count-min-sketch frequency admission: count each missed key in every
    hash row (in place), then admit it once its smallest count reaches
    `admit_threshold`. Keys that share a column count more than once, as in
    the reference (for each hash row, add first, then read). Threshold <= 1
    admits every miss."""
    thresh = spec.policy.admit_threshold
    if thresh <= 1 or cms.shape[1] == 0:
        return miss
    w = cms.shape[1]
    est = None
    for j in range(4):
        col = hashing.hash_pair(uh, ul, hashing.SALT_CMS[j]) % w
        cms[j].index_add_(0, col, miss.to(torch.int32))  # exact integer adds
        e = cms[j][col]
        est = e if est is None else torch.minimum(est, e)
    return miss & (est >= thresh)


class LookupCtx(NamedTuple):
    """What `lookup_train` hands to the sparse optimizer."""

    slot: torch.Tensor  # i32 [U]; -1 == invalid, denied or dropped
    found: torch.Tensor  # bool [U] key pre-existed
    fresh: torch.Tensor  # bool [U] inserted by this lookup
    rows_u: torch.Tensor  # f32 [U, dim] rows as read (fresh: init; slot < 0: zeros)


def lookup_train(spec: TableSpec, shard: TableShard, uh, ul, valid, step: int) -> LookupCtx:
    """Training lookup of deduplicated keys, in place: probe, CMS admission,
    insert planning, and the side-plane writes of fresh keys (key, freq = 1,
    last = step), without touching the values plane. Found rows are read
    from the values plane as it was before any write; fresh rows take
    `hashing.default_rows`. The values plane then receives init + optimizer
    delta in one update (`optim.apply_sparse_grads_ctx`).

    The reference writes fresh keys as adds over the sentinel and zero state
    of free slots; the port sets them, which gives the same bits. Nothing
    branches on whether any key is fresh: a launch whose indices are all -1
    writes nothing. With `policy.needs_scores`, found keys also get
    freq += 1 and last = step."""
    with span("meepo.table.lookup"):
        pr = probe(spec, shard, uh, ul, valid)
        miss = valid & ~pr.found
        admit = cms_admit(spec, shard.cms, uh, ul, miss)
        plan = plan_insert(spec, shard, uh, ul, admit)
        with span("meepo.table.fresh"):
            slot = torch.where(pr.found, pr.slot, plan.slot)
            fresh = plan.ok

            rows = gather_values(shard.values, slot)
            init = hashing.default_rows(uh, ul, spec.dim, spec.initializer_scale, spec.dtype,
                                        kind=spec.initializer, lane_offset=spec.init_lane_offset)
            rows_u = torch.where(fresh[:, None], init, rows).float()
            rows_u.masked_fill_((slot < 0)[:, None], 0.0)

            scatter_bucket_planes(set_index(slot, fresh), [
                (shard.key_hi, uh), (shard.key_lo, ul), (shard.freq, 1), (shard.last, step)])
            if spec.policy.needs_scores:
                touch(shard, slot, pr.found, step)

            shard.cnt.copy_(plan.cnt)
            shard.ovf.copy_(plan.ovf)
            events = torch.stack([pr.found.sum(), miss.sum(), fresh.sum(), (admit & ~fresh).sum(),
                                  (miss & ~admit).sum()]).to(torch.int32)
            with span("meepo.table.counters_sync"):  # the index's copy waits on the stream
                at = torch.tensor([HITS, MISSES, INSERTS, DROPS, DENIED], device=events.device)
            shard.counters.index_add_(0, at, events)
            return LookupCtx(slot=slot, found=pr.found, fresh=fresh, rows_u=rows_u)


class EvictExport(NamedTuple):
    """What `evict_pass` hands to the spill tier: E = `max_evict_per_pass`
    rows, the first `count` of them evicted, the rest fill (sentinel keys,
    zeros), as in the reference."""

    hi: torch.Tensor  # i32 [E]
    lo: torch.Tensor  # i32 [E]
    rows: torch.Tensor  # [E, dim] values, the plane's type
    freq: torch.Tensor  # i32 [E]
    accum: torch.Tensor  # f32 [E] rowwise optimizer state (zeros if none)
    fulldim: Tuple[torch.Tensor, ...]  # each [E, dim] full-dim optimizer slots
    count: int  # number of valid entries


def _flat(plane: torch.Tensor) -> torch.Tensor:
    """The [nb * 128, 1] view of a bucket plane: one row a slot."""
    return plane.view(-1, 1)


def clear_slots(shard: TableShard, slot: torch.Tensor, sel: torch.Tensor) -> None:
    """Free the selected (unique) slots in place: the key planes back to the
    sentinel, freq, last, the accumulator, the values and the full-dim
    planes to 0 (the state `alloc_shard` gives a free slot), in two set
    launches, and cnt -= 1 a slot.

    The reference frees a slot by exact subtraction (keys by int32
    wraparound, floats by x - x == +0) to avoid scatters on the TPU; setting
    gives the same bits for finite rows. A row holding NaN or inf differs:
    the reference leaves NaN in its freed slot, the port 0."""
    idx = set_index(slot, sel)
    side = [(shard.key_hi, hashing.EMPTY_HI), (shard.key_lo, hashing.EMPTY_LO),
            (shard.freq, 0), (shard.last, 0)]
    if shard.opt_rowwise:
        side.append((shard.opt_rowwise[0], 0.0))
    scatter_bucket_planes(idx, side)
    scatter_set_values(idx, [(shard.values, 0)] + [(p, 0) for p in shard.opt_fulldim])
    # several freed slots may share a bucket: an [nb + 1] buffer takes the
    # adds, its last element the unselected ones
    nb = shard.cnt.shape[0]
    cnt = torch.cat([shard.cnt, shard.cnt.new_zeros(1)])
    cnt.index_add_(0, torch.where(sel, slot // LANES, nb).long(),
                   torch.full(slot.shape, -1, dtype=torch.int32, device=slot.device))
    shard.cnt.copy_(cnt[:nb])


def evict_pass(spec: TableSpec, shard: TableShard, step: int,
               bucket_off: Optional[int] = None) -> EvictExport:
    """One eviction sweep, in place: select cold rows by policy, export up
    to `max_evict_per_pass` of them (for the spill tier) and free their
    slots.

    With `policy.evict_scan_buckets = K` and a `bucket_off`, only the
    buckets [bucket_off, bucket_off + K) mod nb are scanned: one gather of
    those bucket rows of the planes the policy reads, so the last window
    wraps and successive windows tile the ring. `bucket_off=None` (or K
    None or >= nb) scans every bucket. The rows taken are the first E set
    lanes in window order (the reference's `nonzero(size=E)`); the exports'
    gathers use global slots: the 4-byte planes in one launch, values and
    full-dim planes in another."""
    pol = spec.policy
    E, K, nb = pol.max_evict_per_pass, pol.evict_scan_buckets, spec.num_buckets
    dev = shard.key_hi.device
    lfu = pol.evict_policy in ("lfu", "lfu_ttl")
    ttl = pol.evict_policy in ("ttl", "lfu_ttl")
    planes = [shard.key_hi, shard.key_lo] + [shard.freq] * lfu + [shard.last] * ttl
    if K is None or K >= nb or bucket_off is None:
        wrows = torch.arange(nb, dtype=torch.int64, device=dev)
        win = planes
    else:
        wrows = (int(bucket_off) % nb + torch.arange(K, dtype=torch.int64, device=dev)) % nb
        win = row_gather_multi(planes, wrows.to(torch.int32))
    cold = torch.zeros(win[0].shape, dtype=torch.bool, device=dev)
    if lfu:
        cold |= win[2] < pol.lfu_min_freq
    if ttl:
        cold |= (step - win[-1]) > pol.ttl_steps  # int32, wrapping as the reference
    (idx,) = (hashing.is_valid(win[0], win[1]) & cold).view(-1).nonzero(as_tuple=True)
    count = min(E, idx.shape[0])
    sel = torch.arange(E, device=dev) < count
    idx_c = torch.zeros((E,), dtype=torch.int64, device=dev)
    idx_c[:count] = idx[:count]
    # window-local flat index -> global slot, through the wrapped bucket map
    slot = torch.where(sel, wrows[idx_c // LANES] * LANES + idx_c % LANES, 0).to(torch.int32)

    four = [shard.key_hi, shard.key_lo, shard.freq] + list(shard.opt_rowwise[:1])
    got = [x.view(-1) for x in row_gather_multi([_flat(p) for p in four], slot)]
    vals = gather_values_multi((shard.values, *shard.opt_fulldim), slot)
    clear_slots(shard, slot, sel)
    shard.counters[EVICTIONS] += count

    keep = sel[:, None]
    return EvictExport(
        hi=torch.where(sel, got[0], hashing.EMPTY_HI),
        lo=torch.where(sel, got[1], hashing.EMPTY_LO),
        rows=vals[0].masked_fill_(~keep, 0),
        freq=torch.where(sel, got[2], 0),
        accum=(torch.where(sel, got[3], 0.0) if shard.opt_rowwise else
               torch.zeros((E,), dtype=torch.float32, device=dev)),
        fulldim=tuple(f.masked_fill_(~keep, 0) for f in vals[1:]),
        count=count,
    )


def next_evict_cursor(spec: TableSpec, cursor: int) -> int:
    """The next evict-scan window: advance by K buckets modulo nb. The
    windows wrap, so successive ones tile the bucket ring exactly even when
    K does not divide nb."""
    K = spec.policy.evict_scan_buckets
    nb = spec.num_buckets
    if K is None or K >= nb:
        return 0
    return (cursor + K) % nb


def erase_keys(spec: TableSpec, shard: TableShard, uh, ul, valid) -> torch.Tensor:
    """Explicit removal of deduplicated keys, in place: probe them and free
    every found slot as eviction does (`clear_slots`). Returns the found
    mask; absent keys are a no-op. `ovf` is left as it is: probing runs its
    rounds whatever the buckets hold, so a freed slot mid-chain never hides
    another key."""
    pr = probe(spec, shard, uh, ul, valid)
    clear_slots(shard, torch.where(pr.found, pr.slot, 0), pr.found)
    shard.counters[ERASES] += pr.found.sum().to(torch.int32)
    return pr.found


def check_invariants(spec: TableSpec, shard: TableShard, chunk_buckets: int = 1 << 15) -> dict:
    """Violation counts of a shard's invariants, all 0 on a healthy shard
    (for tests and debug ticks, not the hot path):

      cnt_mismatch      sum over buckets of |live lanes - cnt|
      bad_placement     live keys outside their probe window
      dup_keys          live slots whose key another live slot holds too
      free_values_resid 1 if a free slot's values are not all 0, else 0
                        (a NaN there reads as 0, as in the reference)
      load_overflow     buckets with cnt > 128

    The planes are read in chunks of `chunk_buckets` buckets, so no
    temporary grows with the table beyond the live ids the duplicate check
    sorts (int64, the joined key)."""
    nb = spec.num_buckets
    dev = shard.key_hi.device
    rounds = min(spec.max_probe_rounds, nb)
    mismatch = bad = 0
    resid = torch.zeros((), dtype=torch.float32, device=dev)
    ids = []
    for b0 in range(0, nb, chunk_buckets):
        b1 = min(nb, b0 + chunk_buckets)
        kh, kl = shard.key_hi[b0:b1], shard.key_lo[b0:b1]
        lm = hashing.is_valid(kh, kl)
        mismatch += (lm.sum(dim=1, dtype=torch.int32) - shard.cnt[b0:b1]).abs().sum()
        here = torch.arange(b0, b1, dtype=torch.int32, device=dev)[:, None]
        bad += (lm & ((hashing.bucket_of(kh, kl, nb) ^ here) >= rounds)).sum()
        rows = shard.values[b0 * LANES:b1 * LANES].float().abs()
        resid += rows.masked_fill_(lm.view(-1, 1), 0.0).sum()
        ids.append(((kh.long() << 32) | (kl.long() & hashing.M32))[lm])
    s = torch.sort(torch.cat(ids)).values
    return {
        "cnt_mismatch": int(mismatch),
        "bad_placement": int(bad),
        "dup_keys": int((s[1:] == s[:-1]).sum()),
        "free_values_resid": int(bool(resid > 0)),
        "load_overflow": int((shard.cnt > LANES).sum()),
    }


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

    # one launch for each group of planes that share a mask and a view: the
    # fresh keys, the side planes, the rows
    scatter_bucket_planes(set_index(slot, fresh), [(shard.key_hi, hi), (shard.key_lo, lo)])
    ok_idx = set_index(slot, ok)
    side = [(shard.freq, 1 if freq is None else freq),
            (shard.last, step if last is None else last)]
    if shard.opt_rowwise:
        a = spec.optimizer.initial_accumulator if accum is None else accum
        side.append((shard.opt_rowwise[0], a))
    scatter_bucket_planes(ok_idx, side)
    scatter_set_values(ok_idx, [(shard.values, rows)] + [
        (plane, 0 if fulldim is None else fulldim[j])
        for j, plane in enumerate(shard.opt_fulldim)])
    shard.cnt.copy_(plan.cnt)
    shard.ovf.copy_(plan.ovf)
    shard.counters[INSERTS] += fresh.sum().to(torch.int32)
    return ok
