"""Ragged all-to-all id, row and gradient exchange (port of
`meepoembedding_tpu/parallel/ragged.py`).

The dense exchange (`sharded_table.py`) sends fixed [S, cap] buffers each
way, `factor * U` rows whatever routed where. This one sends only the rows
that route: the send buffer is the local uniques sorted by owner, and the
payload rides `dist.all_to_all_single` with per-rank split sizes, torch's
native ragged all-to-all.

  volume        sum(send) <= U rows each way, not factor * U.
  drops         a receiver takes at most `rcap = factor * U` rows in all;
                the sources' segments are clamped in source order past
                that, counted in ROUTE_DROPS (the dense exchange drops
                where one (source, destination) pair overflows).
  owner side    the same as the dense exchange's, over rcap slots.

The plan costs one host synchronisation an exchange: the split sizes must
be host integers, so the [S] count vectors of every rank (one all_gather)
come to the host, where the clamp is worked out. torch packs what it
receives by source, so each side places the rows itself: a receiver's
chunks are contiguous (a clamp only cuts the tail), and the rows that come
back land at the unique ids they left from, which leaves the clamped ones
zero. The reference's remote write offsets have no counterpart.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from meepoembedding_tpu_torch.config import LANES
from meepoembedding_tpu_torch.parallel import sharded_table as st
from meepoembedding_tpu_torch.parallel.mesh import Mesh
from meepoembedding_tpu_torch.table import hashing
from meepoembedding_tpu_torch.table.layout import TableShard, TableSpec


def ragged_recv_cap(unique_cap: int, num_shards: int, factor: float = 1.25) -> int:
    """Static receiver rows. The expected inflow is ~U (each of S sources
    routes ~U/S ids here); `factor` is headroom against hash imbalance."""
    cap = int(factor * unique_cap)
    cap = max(LANES, -(-cap // LANES) * LANES)
    return min(cap, num_shards * unique_cap)


class RaggedPlan(NamedTuple):
    """One exchange's geometry; both payload directions and the gradients'
    way back ride it."""

    src: torch.Tensor  # i64 [sum(send)] the unique ids that leave, in wire order
    ok: torch.Tensor  # bool [U] survived the receiver's clamp
    send: List[int]  # clamped rows to each destination
    recv: List[int]  # clamped rows from each source
    n_drop: torch.Tensor  # i32 [] local ids past a receiver's clamp


def make_plan(uh, ul, valid, S: int, rcap: int, mesh: Mesh,
              owner_sorted: bool = False) -> RaggedPlan:
    """Sort the uniques by owner (or take them as sorted: `owner_sorted`
    declares what `dedup.unique_pairs(owner_major=S)` gives, invalid ids
    last, and skips the sort), gather every rank's per-destination counts
    [S_src, S_dst] in one all_gather, and clamp each receiver's inflow at
    `rcap` in source order."""
    dev = uh.device
    owner, order, starts, rank = st.owner_groups(uh, ul, valid, S, presorted=owner_sorted)
    want = starts[1:] - starts[:-1]
    got = [torch.empty_like(want) for _ in range(S)]
    dist.all_gather(got, want, group=mesh.group)
    C = torch.stack(got).cpu().numpy()  # C[src, dst]; the host sync
    ahead = np.concatenate([np.zeros((1, S), C.dtype), np.cumsum(C, axis=0)[:-1]])
    me = mesh.rank
    recv = np.clip(rcap - ahead[:, me], 0, C[:, me])
    send = np.clip(rcap - ahead[me], 0, C[me])
    send_t = torch.from_numpy(send).to(dev)
    ok = valid & (rank < send_t[owner.clamp(0, S - 1).long()])
    # sorted positions that leave: each destination's segment start, then
    # the first send[j] rows of it
    total = int(send.sum())
    shift = torch.from_numpy(np.cumsum(C[me]) - C[me] - (np.cumsum(send) - send)).to(dev)
    seg = torch.repeat_interleave(torch.arange(S, device=dev), send_t, output_size=total)
    pos = torch.arange(total, dtype=torch.int64, device=dev) + shift[seg]
    return RaggedPlan(src=order[pos], ok=ok, send=send.tolist(), recv=recv.tolist(),
                      n_drop=(valid & ~ok).sum().to(torch.int32))


def _transport(packed: torch.Tensor, out_split: List[int], in_split: List[int],
               mesh: Mesh) -> torch.Tensor:
    out = packed.new_empty((sum(out_split),) + tuple(packed.shape[1:]))
    dist.all_to_all_single(out, packed.contiguous(), output_split_sizes=out_split,
                           input_split_sizes=in_split, group=mesh.group)
    return out


class RaggedCtx(NamedTuple):
    """The plan and the owner-side lookup, for the gradients' way back (the
    ragged counterpart of `sharded_table.RouteCtx`)."""

    plan: RaggedPlan
    lctx: object  # table_ops.LookupCtx (train) or the i32 slots (probe)
    inverse: torch.Tensor  # i32 [rcap] owner-side dedup inverse
    order: torch.Tensor  # i64 [rcap] the owner dedup's sort
    sorted_ids: torch.Tensor  # i32 [rcap]
    miss_hi: torch.Tensor
    miss_lo: torch.Tensor
    miss: torch.Tensor
    n_drop: torch.Tensor


def exchange_lookup(spec: TableSpec, shard: TableShard, uh, ul, valid, step: int,
                    mesh: Mesh, rcap: int, train: bool = True, owner_sorted: bool = False):
    """`sharded_table.exchange_lookup` over the ragged transport: returns
    (emb_u [U, dim] f32, RaggedCtx)."""
    plan = make_plan(uh, ul, valid, mesh.size, rcap, mesh, owner_sorted=owner_sorted)
    ids = _transport(torch.stack([uh, ul], dim=1)[plan.src], plan.recv, plan.send, mesh)
    m = ids.shape[0]
    rbuf = torch.empty((rcap, 2), dtype=torch.int32, device=uh.device)
    rbuf[:, 0] = hashing.EMPTY_HI
    rbuf[:, 1] = hashing.EMPTY_LO
    rbuf[:m] = ids
    rows, runiq, lctx, found = st.owner_lookup(spec, shard, rbuf[:, 0].contiguous(),
                                               rbuf[:, 1].contiguous(), step, train)
    back = _transport(rows[:m], plan.send, plan.recv, mesh)
    emb_u = torch.zeros((uh.shape[0], spec.dim), dtype=torch.float32, device=uh.device)
    emb_u[plan.src] = back.float()
    if train:
        shard.counters[st.ROUTE_DROPS] += plan.n_drop
    return emb_u, RaggedCtx(plan=plan, lctx=lctx, inverse=runiq.inverse, order=runiq.order,
                            sorted_ids=runiq.sorted_ids, miss_hi=runiq.hi, miss_lo=runiq.lo,
                            miss=runiq.valid & ~found, n_drop=plan.n_drop)


def exchange_apply_grads(spec: TableSpec, shard: TableShard, ctx: RaggedCtx, g_u,
                         mesh: Mesh, rcap: int, g2_mean=None) -> None:
    """The gradients' way back over the forward plan: per-unique gradients
    to their owners (in `sharded_table.wire_dtype`), summed per key there,
    one in-place update a key (`g2_mean`: `st.owner_update`'s)."""
    plan = ctx.plan
    got = _transport(g_u.to(st.wire_dtype(spec))[plan.src], plan.recv, plan.send, mesh)
    recv_g = got.new_zeros((rcap, spec.dim))
    recv_g[:got.shape[0]] = got
    st.owner_update(spec, shard, ctx, recv_g, g2_mean=g2_mean)
