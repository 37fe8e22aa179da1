"""The differentiable embedding lookup and its sparse update, for models
that the built-in trainers do not cover (port of
`meepoembedding_tpu/embed.py`).

    from meepoembedding_tpu_torch import embed

    ctx, emb = embed.lookup(spec, shard, hi, lo, step)   # emb: [*hi.shape, dim]
    loss = my_loss(emb)
    (g_emb,) = torch.autograd.grad(loss, [emb])          # or emb.retain_grad()
    embed.update(spec, shard, ctx, g_emb)                # in-place sparse optimizer

The semantics are the fused trainers':

- `lookup` dedups the batch, probes and inserts once a unique id
  (`table_ops.lookup_train`), and returns the rows in batch order through
  `dedup.GatherRows` (K2 forward; K1 `segment_sum` backward, on the
  dedup's own sort). Fresh ids read their deterministic init; the values
  plane receives it only in `update`.
- `emb` is an ordinary differentiable f32 tensor. `update` segment-sums
  the batch-order grads of duplicates and applies the configured sparse
  optimizer in place (`optim.apply_sparse_grads_ctx`: init and delta in
  one values update). `update_window` takes grads already per unique id,
  for instance `ctx.rows_u.grad` after `loss.backward()`.
- Invalid ids (the empty sentinel, e.g. bag padding) read zero rows and
  receive no update.

The table is updated in place (the reference threads the shard through
its functions instead).

CONTRACT: a `train=True` lookup is paired with exactly one `update` before
the next lookup (zero grads are fine). An unpaired train lookup leaves its
fresh keys registered with zero values rows. The reference does the same
for dim <= 128 only; for dim > 128 it writes the init rows at lookup. The
port has one layout for every dim and so follows the first rule on all.
Use `train=False` for lookups that no update follows: it inserts nothing,
and unknown ids read zero rows.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from meepoembedding_tpu_torch.ops import dedup, optim
from meepoembedding_tpu_torch.table import table_ops
from meepoembedding_tpu_torch.table.layout import TableShard, TableSpec


class EmbedCtx(NamedTuple):
    """What `lookup` hands to `update` (one batch)."""

    slot: torch.Tensor  # i32 [U]; -1 == invalid, denied or dropped
    found: torch.Tensor  # bool [U]
    fresh: torch.Tensor  # bool [U] inserted by this lookup
    rows_u: torch.Tensor  # f32 [U, dim] leaf that `emb` is gathered from
    inverse: torch.Tensor  # i32 [n] batch position -> unique index
    count: torch.Tensor  # i32 [] number of uniques
    order: torch.Tensor  # the dedup's stable sort, for the segment sum
    sorted_ids: torch.Tensor

    @property
    def lookup_ctx(self) -> table_ops.LookupCtx:
        return table_ops.LookupCtx(self.slot, self.found, self.fresh, self.rows_u.detach())


def lookup(spec: TableSpec, shard: TableShard, hi: torch.Tensor, lo: torch.Tensor, step: int,
           *, unique_cap: Optional[int] = None,
           train: bool = True) -> Tuple[EmbedCtx, torch.Tensor]:
    """Deduplicated find-or-insert lookup, in place. -> (ctx, emb).

    hi/lo: int32 id halves (`hashing.split_ids_t`), any shape, on the
    shard's device; `emb` comes back f32, shaped `hi.shape + (dim,)`.

    `unique_cap` bounds the dedup's output (default: the number of ids,
    always lossless). A cap below the true unique count aliases the
    overflow ids onto the last unique slot, as in the reference: they read
    each other's row and their grads mix. `ctx.count == cap` afterwards
    means the cap was hit."""
    batch_shape = tuple(hi.shape)
    hi_f, lo_f = hi.reshape(-1), lo.reshape(-1)
    uniq = dedup.unique_pairs(hi_f, lo_f, int(unique_cap or hi_f.shape[0]))
    if train:
        lctx = table_ops.lookup_train(spec, shard, uniq.hi, uniq.lo, uniq.valid, int(step))
        slot, found, fresh, rows = lctx.slot, lctx.found, lctx.fresh, lctx.rows_u
    else:
        rows, (slot, found) = table_ops.lookup_probe(spec, shard, uniq.hi, uniq.lo, uniq.valid)
        fresh = torch.zeros_like(found)
        rows = rows.float()
    rows_u = rows.detach().requires_grad_(True)
    ctx = EmbedCtx(slot, found, fresh, rows_u, uniq.inverse, uniq.count, uniq.order,
                   uniq.sorted_ids)
    emb = dedup.GatherRows.apply(rows_u, uniq.inverse, uniq.order, uniq.sorted_ids)
    return ctx, emb.reshape(batch_shape + (spec.dim,))


@torch.no_grad()
def update(spec: TableSpec, shard: TableShard, ctx: EmbedCtx, grads: torch.Tensor) -> None:
    """Apply batch-order grads ([*batch, dim], the gradient of `emb`)
    through the configured sparse optimizer, in place. Duplicates are
    segment-summed; fresh rows receive init + first update in one values
    update."""
    g = grads.reshape(-1, spec.dim)
    g_u = dedup.segment_sum_grads(g, ctx.inverse, ctx.rows_u.shape[0], ctx.order,
                                  ctx.sorted_ids)
    optim.apply_sparse_grads_ctx(spec, shard, ctx.lookup_ctx, g_u)


@torch.no_grad()
def update_window(spec: TableSpec, shard: TableShard, ctx: EmbedCtx,
                  g_u: torch.Tensor) -> None:
    """`update` from [U, dim] grads per unique id, e.g. `ctx.rows_u.grad`
    after `loss.backward()` (the reference's window-space variant: in the
    port the window is the row)."""
    optim.apply_sparse_grads_ctx(spec, shard, ctx.lookup_ctx, g_u)
