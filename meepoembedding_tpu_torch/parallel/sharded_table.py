"""Row-sharded table with the all-to-all id exchange (port of
`meepoembedding_tpu/parallel/sharded_table.py`).

Each rank owns one table shard; `owner(key) = hash(key) >> k` routes every
id to exactly one of them. One exchange, from every rank at once:

  source side   dedup the local batch's ids, bucket them by owner and place
                them in an [S, cap] send buffer (cap per destination; ids
                beyond it are dropped and counted in ROUTE_DROPS, and the
                trainer doubles the factor when that happens).
  all_to_all    ids out, rows back and gradients back ride the same plan:
                `dist.all_to_all_single` on the contiguous [S * cap, ...]
                view of the buffer.
  owner side    dedup the received ids again (one key can arrive from many
                sources; without this a new key would take several slots),
                look them up (`table_ops.lookup_train` or `probe`) and
                gather their rows by the dedup's inverse.

Gradients take the forward plan back and are segment-summed on the owner
(K1's `segment_sum`, on the owner dedup's own sort) before one in-place
sparse update a key (`optim.apply_sparse_grads_ctx`). The shard is updated
in place.

`FORCE_EXCHANGE` (read at call time) runs the exchange on a world of one,
where the fast path would skip it, so one card can price the exchange.
`GRAD_WIRE_BF16` (`MEEPO_GRAD_WIRE_BF16`, default on) sends a bf16 table's
gradients in bf16: half the bytes, quantized before the owner's f32
segment sum, so at S > 1 a bf16 table's update differs from the S == 1
path's in the last bf16 place. No mask crosses the wire: an empty place
holds the invalid id, or a zero row.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist

from meepoembedding_tpu_torch.config import LANES
from meepoembedding_tpu_torch.kernels import row_gather
from meepoembedding_tpu_torch.ops import dedup, optim
from meepoembedding_tpu_torch.parallel.mesh import Mesh
from meepoembedding_tpu_torch.table import hashing, table_ops
from meepoembedding_tpu_torch.table.layout import TableShard, TableSpec

ROUTE_DROPS = 8  # counters index (the layout's counters leave it to this layer)

FORCE_EXCHANGE = False
GRAD_WIRE_BF16 = os.environ.get("MEEPO_GRAD_WIRE_BF16", "1") != "0"


def exchanging(mesh: Mesh) -> bool:
    """Whether lookups on `mesh` run the exchange (S > 1, or forced)."""
    return mesh.size > 1 or FORCE_EXCHANGE


def a2a_capacity(unique_cap: int, num_shards: int, factor: float = 1.25) -> int:
    """Static per-(source, destination) buffer rows; factor >= S is
    lossless. Per-destination counts are binomial(U, 1/S) under the owner
    hash, so 1.25 is tens of sigma of headroom at real batch sizes."""
    if num_shards == 1:
        return unique_cap
    cap = int(factor * unique_cap / num_shards)
    cap = max(LANES, -(-cap // LANES) * LANES)
    return min(cap, unique_cap)


class RouteCtx(NamedTuple):
    """The forward plan and the owner-side lookup, for the gradient's way
    back (the ragged exchange has its own, `ragged.RaggedCtx`)."""

    owner: torch.Tensor  # i32 [U] owning shard of each local unique id
    pos: torch.Tensor  # i64 [U] position in the owner's send block
    ok: torch.Tensor  # bool [U] placed within capacity
    lctx: object  # table_ops.LookupCtx (train) or the i32 slots (probe)
    inverse: torch.Tensor  # i32 [S * cap] owner-side dedup inverse
    order: torch.Tensor  # i64 [S * cap] the owner dedup's sort, for the segment sum
    sorted_ids: torch.Tensor  # i32 [S * cap] inverse[order]
    # what this shard received and did not hold (the promotion feed)
    miss_hi: torch.Tensor
    miss_lo: torch.Tensor
    miss: torch.Tensor
    n_drop: torch.Tensor  # i32 [] local ids dropped for capacity


def owner_groups(uh, ul, valid, S: int, presorted: bool = False):
    """Group the unique ids by owner shard (invalid ids in group S, last):
    (owner, order: the stable sort by owner, starts: [S + 1] each group's
    first sorted position, rank: each id's position within its group, in
    input order). `presorted` declares the ids grouped already, as
    `dedup.unique_pairs(owner_major=S)` gives them. Ranks are the
    reference's segmented ranks, found by S + 1 binary searches."""
    owner = torch.where(valid, hashing.owner_of(uh, ul, S), S)
    idx = torch.arange(owner.shape[0], dtype=torch.int64, device=owner.device)
    order = idx if presorted else torch.sort(owner, stable=True)[1]
    ks = owner[order]
    starts = torch.searchsorted(ks, torch.arange(S + 1, dtype=ks.dtype, device=ks.device))
    rank = torch.empty_like(idx)
    rank[order] = idx - starts[ks.long()]
    return owner, order, starts, rank


def _route(uh, ul, valid, num_shards: int, cap: int):
    """(owner, position within the owner's block, placed) of each unique
    id: positions in id order within each owner."""
    owner, _, _, pos = owner_groups(uh, ul, valid, num_shards)
    return owner, pos, valid & (pos < cap)


def _flat_index(owner, pos, ok, S: int, cap: int) -> torch.Tensor:
    """Row of each placed id in the flat [S * cap] buffer; S * cap (a spare
    row) for the rest."""
    return torch.where(ok, owner.long() * cap + pos, S * cap)


def all_to_all(send: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Equal blocks of the leading axis to every rank, and theirs back."""
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send.contiguous(), group=mesh.group)
    return recv


def _a2a_ids(uh, ul, flat, S: int, cap: int, mesh: Mesh):
    """The (hi, lo) halves of the ids to their owners in one fused [S * cap,
    2] int32 exchange; empty places hold the invalid id."""
    send = torch.empty((S * cap + 1, 2), dtype=torch.int32, device=uh.device)
    send[:, 0] = hashing.EMPTY_HI
    send[:, 1] = hashing.EMPTY_LO
    send[flat] = torch.stack([uh, ul], dim=1)
    recv = all_to_all(send[:S * cap], mesh)
    return recv[:, 0].contiguous(), recv[:, 1].contiguous()


def owner_lookup(spec: TableSpec, shard: TableShard, rhi, rlo, step: int, train: bool):
    """The owner side of an exchange, shared with the ragged one: dedup the
    received ids, look them up, and return (rows [n, dim] in the table's
    type, in received order; the dedup; the lookup's ctx; found)."""
    runiq = dedup.unique_pairs(rhi, rlo, size=rhi.shape[0])
    if train:
        lctx = table_ops.lookup_train(spec, shard, runiq.hi, runiq.lo, runiq.valid, step)
        rows = row_gather(lctx.rows_u.to(spec.dtype).contiguous(), runiq.inverse)
        return rows, runiq, lctx, lctx.found
    # one gather of the values plane, straight in received order
    rows, pr = table_ops.lookup_probe(spec, shard, runiq.hi, runiq.lo, runiq.valid,
                                      order=runiq.inverse)
    return rows, runiq, pr.slot, pr.found


def exchange_lookup(spec: TableSpec, shard: TableShard, uh, ul, valid, step: int,
                    mesh: Mesh, cap: int, train: bool = True, ragged: bool = False,
                    owner_sorted: bool = False):
    """Sharded find-or-insert (train) or probe of local unique ids. Returns
    (emb_u [U, dim] f32, ctx for `exchange_apply_grads`). A train lookup
    updates the shard in place and adds its route drops to its counters; a
    probe leaves the shard as it is (the reference's callers discard the
    shard it returns) and gives its drops in `ctx.n_drop`.

    `ragged=True` routes the payload over `parallel/ragged.py`; `cap` is
    then the receiver's total (`ragged_recv_cap`), not the per-pair
    capacity. The world-of-one fast path (no `FORCE_EXCHANGE`) is the
    single-device lookup: every id is local and already deduplicated."""
    S = mesh.size
    if not exchanging(mesh):
        n = uh.shape[0]
        ar = torch.arange(n, dtype=torch.int32, device=uh.device)
        zero = torch.zeros((n,), dtype=torch.int32, device=uh.device)
        if train:
            lctx = table_ops.lookup_train(spec, shard, uh, ul, valid, step)
            found, emb_u = lctx.found, lctx.rows_u
        else:
            rows, (lctx, found) = table_ops.lookup_probe(spec, shard, uh, ul, valid)
            emb_u = rows.float()
        return emb_u, RouteCtx(owner=zero, pos=ar, ok=valid, lctx=lctx, inverse=ar,
                               order=ar.long(), sorted_ids=ar, miss_hi=uh, miss_lo=ul,
                               miss=valid & ~found, n_drop=zero.new_zeros(()))
    if ragged:
        from meepoembedding_tpu_torch.parallel import ragged as rg

        return rg.exchange_lookup(spec, shard, uh, ul, valid, step, mesh, cap, train=train,
                                  owner_sorted=owner_sorted)
    owner, pos, ok = _route(uh, ul, valid, S, cap)
    flat = _flat_index(owner, pos, ok, S, cap)
    rhi, rlo = _a2a_ids(uh, ul, flat, S, cap, mesh)
    rows, runiq, lctx, found = owner_lookup(spec, shard, rhi, rlo, step, train)
    back = all_to_all(rows, mesh)
    emb_u = row_gather(back, torch.where(ok, flat, 0).to(torch.int32)).float()
    emb_u.masked_fill_(~ok[:, None], 0.0)
    n_drop = (valid & ~ok).sum().to(torch.int32)
    if train:
        shard.counters[ROUTE_DROPS] += n_drop
    return emb_u, RouteCtx(owner=owner, pos=pos, ok=ok, lctx=lctx, inverse=runiq.inverse,
                           order=runiq.order, sorted_ids=runiq.sorted_ids, miss_hi=runiq.hi,
                           miss_lo=runiq.lo, miss=runiq.valid & ~found, n_drop=n_drop)


def wire_dtype(spec: TableSpec) -> torch.dtype:
    """The gradients' type on the wire: a bf16 table's own type (its update
    rounds to bf16 anyway), unless `GRAD_WIRE_BF16` is off; else f32."""
    return spec.dtype if spec.dtype == torch.bfloat16 and GRAD_WIRE_BF16 else torch.float32


def owner_update(spec: TableSpec, shard: TableShard, ctx, recv_g: torch.Tensor,
                 g2_mean=None) -> None:
    """Segment-sum the received per-id gradients [n, dim] by the owner
    dedup (in f32) and apply one sparse update a key, in place. `g2_mean`:
    `optim.apply_sparse_grads_ctx`'s accumulator hook."""
    g = dedup.segment_sum_grads(recv_g.float(), ctx.inverse, ctx.inverse.shape[0],
                                order=ctx.order, sorted_ids=ctx.sorted_ids)
    optim.apply_sparse_grads_ctx(spec, shard, ctx.lctx, g, g2_mean=g2_mean)


def exchange_apply_grads(spec: TableSpec, shard: TableShard, ctx, g_u: torch.Tensor,
                         mesh: Mesh, cap: int, g2_mean=None) -> None:
    """The way back: per-unique gradients [U, dim] to their owners over the
    forward plan, summed per key there, one in-place update a key. A
    `RaggedCtx` takes the ragged way back. `g2_mean` is passed to the
    owner's update (`optim.apply_sparse_grads_ctx`)."""
    from meepoembedding_tpu_torch.parallel import ragged as rg

    if isinstance(ctx, rg.RaggedCtx):
        rg.exchange_apply_grads(spec, shard, ctx, g_u, mesh, cap, g2_mean=g2_mean)
        return
    if not exchanging(mesh):
        optim.apply_sparse_grads_ctx(spec, shard, ctx.lctx, g_u, g2_mean=g2_mean)
        return
    S = mesh.size
    send = torch.zeros((S * cap + 1, spec.dim), dtype=wire_dtype(spec), device=g_u.device)
    send[_flat_index(ctx.owner, ctx.pos, ctx.ok, S, cap)] = g_u.to(send.dtype)
    owner_update(spec, shard, ctx, all_to_all(send[:S * cap], mesh), g2_mean=g2_mean)


def exchange_erase(spec: TableSpec, shard: TableShard, uh, ul, valid, mesh: Mesh,
                   cap: int) -> torch.Tensor:
    """Sharded key removal: ids route to their owners over the exchange
    (the input may be the same on every rank: the owner's dedup folds the
    S copies) and found keys are erased there. Returns the global removed
    count (an i32 tensor; each key is erased on one owner, so the sum is
    exact)."""
    if not exchanging(mesh):
        runiq = dedup.unique_pairs(uh, ul, size=uh.shape[0])
        return table_ops.erase_keys(spec, shard, runiq.hi, runiq.lo,
                                    runiq.valid).sum().to(torch.int32)
    S = mesh.size
    owner, pos, ok = _route(uh, ul, valid, S, cap)
    rhi, rlo = _a2a_ids(uh, ul, _flat_index(owner, pos, ok, S, cap), S, cap, mesh)
    runiq = dedup.unique_pairs(rhi, rlo, size=rhi.shape[0])
    removed = table_ops.erase_keys(spec, shard, runiq.hi, runiq.lo,
                                   runiq.valid).sum().to(torch.int32).reshape(1)
    dist.all_reduce(removed, group=mesh.group)
    shard.counters[ROUTE_DROPS] += (valid & ~ok).sum().to(torch.int32)
    return removed[0]
