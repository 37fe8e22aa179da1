"""Sparse in-place optimizers for the table rows and the dense tower's
optimizer (port of `meepoembedding_tpu/ops/optim.py`).

Sparse updates arrive as one gradient row per unique slot (segment-summed),
so every touched slot appears once. Each update gathers the touched rows'
state (the planes of one optimizer in one launch), computes in f32, and adds
the deltas back in place: bucket-plane scalars (the rowwise accumulator)
through `row_scatter_add` (K3) as a fetch-add, which also hands back the
values it added to, row deltas of the values plane and the full-dim state
planes through `row_merge_add` (K1). Slots < 0 (invalid, denied or dropped
ids) update nothing; their old accumulator reads 0 and feeds only rows that
the values update drops.

The reference's rowwise accumulator sums g^2 over 128 window lanes (zeros
outside the row's window); here it sums over `dim` lanes, so accumulators
and values may differ from it in the last places.

The dense optimizer works on lists of tensors (the module's parameters in
order) and updates the parameters in place; its formulas are the
reference's (bias corrections inside `rsqrt(v * c2 + eps^2)`), which
`torch.optim.Adam` does not compute.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from meepoembedding_tpu_torch.table.layout import TableShard, TableSpec
from meepoembedding_tpu_torch.table.table_ops import (
    fetch_add_bucket_plane,
    gather_values_multi,
    scatter_add_values,
)
from meepoembedding_tpu_torch.tracing import span


def apply_sparse_grads_ctx(spec: TableSpec, shard: TableShard, ctx, grad: torch.Tensor,
                           g2_mean=None) -> None:
    """The training step's update after `table_ops.lookup_train`, in place:
    the values plane receives the fresh rows' init plus the optimizer delta
    in ONE `row_merge_add`, and fresh rows' accumulator init rides the
    accumulator add. `grad` is [U, dim], one row per unique slot. sgd and
    rowwise_adagrad take this path; the other kinds write the inits first
    and take `apply_sparse_grads`.

    `g2_mean` maps the raw per-row sum of squared grads [U] to the rowwise
    accumulator's increment (default: / spec.dim). A column block passes
    an all-reduce over its column group divided by the full row's dim, so
    the accumulator stays a full-row statistic, the same on every column."""
    with span("meepo.table.update"):
        opt = spec.optimizer
        slot, fresh = ctx.slot, ctx.fresh
        enabled = slot >= 0
        grad = torch.where(enabled[:, None], grad.float(), 0.0)
        init_add = torch.where(fresh[:, None], ctx.rows_u, 0.0)
        if opt.kind == "sgd":
            scatter_add_values(shard.values, slot, init_add - opt.learning_rate * grad, enabled)
            return
        if opt.kind == "rowwise_adagrad":
            (accum,) = shard.opt_rowwise
            g2 = (grad * grad).sum(dim=1)
            g2 = g2 / spec.dim if g2_mean is None else g2_mean(g2)
            acc_add = g2 + torch.where(fresh, opt.initial_accumulator, 0.0)
            # fresh slots hold 0 before the add
            a_new = fetch_add_bucket_plane(accum, slot, acc_add, enabled) + acc_add
            scale = opt.learning_rate * torch.rsqrt(a_new + opt.eps)
            scatter_add_values(shard.values, slot, init_add - scale[:, None] * grad, enabled)
            return
        # the other kinds keep only full-dim state, zero on fresh slots
        scatter_add_values(shard.values, slot, ctx.rows_u, fresh)
        apply_sparse_grads(spec, shard, slot, grad)


def apply_sparse_grads(spec: TableSpec, shard: TableShard, slot: torch.Tensor,
                       grad: torch.Tensor) -> None:
    """Update the rows at `slot` with per-row grads [n, dim], in place.
    slot < 0 is a no-op. Dispatches on spec.optimizer.kind."""
    opt = spec.optimizer
    enabled = slot >= 0
    grad = torch.where(enabled[:, None], grad.float(), 0.0)
    kind = opt.kind

    def rows(*planes):
        return [r.float() for r in gather_values_multi(planes, slot)]

    if kind == "sgd":
        scatter_add_values(shard.values, slot, -opt.learning_rate * grad, enabled)
    elif kind == "rowwise_adagrad":
        # one accumulator per row: a += mean(g^2); w -= lr / sqrt(a) * g
        (accum,) = shard.opt_rowwise
        g2 = (grad * grad).mean(dim=1)
        a_new = fetch_add_bucket_plane(accum, slot, g2, enabled) + g2
        scale = opt.learning_rate * torch.rsqrt(a_new + opt.eps)
        scatter_add_values(shard.values, slot, -scale[:, None] * grad, enabled)
    elif kind == "adagrad":
        (accum,) = shard.opt_fulldim
        (a_old,) = rows(accum)
        a_new = a_old + grad * grad
        scatter_add_values(accum, slot, a_new - a_old, enabled)
        delta = -opt.learning_rate * grad * torch.rsqrt(a_new + opt.eps)
        scatter_add_values(shard.values, slot, delta, enabled)
    elif kind == "adam":
        # lazy sparse Adam: moments update on touched rows, no bias correction
        m_plane, v_plane = shard.opt_fulldim
        m_old, v_old = rows(m_plane, v_plane)
        m_new = opt.beta1 * m_old + (1 - opt.beta1) * grad
        v_new = opt.beta2 * v_old + (1 - opt.beta2) * grad * grad
        scatter_add_values(m_plane, slot, m_new - m_old, enabled)
        scatter_add_values(v_plane, slot, v_new - v_old, enabled)
        delta = -opt.learning_rate * m_new * torch.rsqrt(v_new + opt.eps * opt.eps)
        scatter_add_values(shard.values, slot, delta, enabled)
    elif kind == "momentum":
        (m_plane,) = shard.opt_fulldim
        (m_old,) = rows(m_plane)
        m_new = opt.beta1 * m_old + grad
        scatter_add_values(m_plane, slot, m_new - m_old, enabled)
        scatter_add_values(shard.values, slot, -opt.learning_rate * m_new, enabled)
    elif kind == "ftrl":
        # FTRL-Proximal: w is a closed form of (z, n); the values plane gets
        # the exact delta w_new - w_old
        z_plane, n_plane = shard.opt_fulldim
        z_old, n_old, w_old = rows(z_plane, n_plane, shard.values)
        alpha = opt.learning_rate
        n_new = n_old + grad * grad
        sigma = (torch.sqrt(n_new) - torch.sqrt(n_old)) / alpha
        z_new = z_old + grad - sigma * w_old
        denom = (opt.ftrl_beta + torch.sqrt(n_new)) / alpha + opt.l2
        w_new = torch.where(z_new.abs() > opt.l1,
                            (torch.sign(z_new) * opt.l1 - z_new) / denom, 0.0)
        scatter_add_values(z_plane, slot, z_new - z_old, enabled)
        scatter_add_values(n_plane, slot, n_new - n_old, enabled)
        scatter_add_values(shard.values, slot, w_new - w_old, enabled)
    else:
        raise ValueError(f"unknown sparse optimizer: {kind}")


# --- dense tower optimizer ------------------------------------------------------

def dense_sgd_init(params: Sequence[torch.Tensor]) -> tuple:
    return ()


@torch.no_grad()
def dense_sgd_update(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                     state, lr: float):
    """p -= lr * g in f32, cast back to the parameter's type; in place."""
    for p, g in zip(params, grads):
        p.copy_((p.float() - lr * g.float()).to(p.dtype))
    return state


def dense_adam_init(params: Sequence[torch.Tensor]
                    ) -> Tuple[List[torch.Tensor], List[torch.Tensor], int]:
    """(m, v, t): moments in f32 whatever the tower's type, and the step."""
    return ([torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params],
            [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params],
            0)


@torch.no_grad()
def dense_adam_update(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                      state, lr: float, b1: float = 0.9, b2: float = 0.999,
                      eps: float = 1e-8):
    """Adam with the bias corrections inside the rsqrt, as the reference:
    p -= lr * (m * c1) * rsqrt(v * c2 + eps^2). Parameters and moments are
    updated in place; returns the new state. The corrections are computed
    on the host in f32 from the step count (no device sync)."""
    m, v, t = state
    t = t + 1
    tf = np.float32(t)
    c1 = float(np.float32(1.0) / (np.float32(1.0) - np.float32(b1) ** tf))
    c2 = float(np.float32(1.0) / (np.float32(1.0) - np.float32(b2) ** tf))
    for p, g, m_, v_ in zip(params, grads, m, v):
        g = g.float()
        m_.mul_(b1).add_((1 - b1) * g)
        v_.mul_(b2).add_((1 - b2) * (g * g))
        upd = lr * (m_ * c1) * torch.rsqrt(v_ * c2 + eps * eps)
        p.copy_((p.float() - upd).to(p.dtype))
    return m, v, t


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """Scale the grads so that their global L2 norm is at most max_norm (the
    norm in f32). max_norm == 0 zeroes them, which freezes the tower."""
    sq = sum((g.float() * g.float()).sum() for g in grads)
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-30), max=1.0)
    return [(g.float() * scale).to(g.dtype) for g in grads]


def schedule_lr(kind: str, base_lr: float, step: int, total_steps: int,
                warmup_steps: int = 0) -> float:
    """The dense tower's learning rate at `step`, computed on the host in f32:
    "constant", "linear" (to 0 over total_steps) or "cosine" (half-cosine to
    0), each with an optional linear warmup first."""
    if kind not in ("constant", "linear", "cosine"):
        raise ValueError(f"unknown lr schedule {kind!r}")
    f32 = np.float32
    t = f32(step)
    scale = f32(1.0)
    if warmup_steps > 0:
        scale = min(t / f32(warmup_steps), f32(1.0))
        t = max(t - f32(warmup_steps), f32(0.0))
    horizon = f32(max(total_steps - warmup_steps, 1))
    frac = f32(min(max(t / horizon, f32(0.0)), f32(1.0)))
    if kind == "linear":
        scale = f32(scale * (f32(1.0) - frac))
    elif kind == "cosine":
        scale = f32(scale * f32(0.5) * (f32(1.0) + f32(np.cos(f32(math.pi) * frac))))
    return float(f32(base_lr) * f32(scale))


def scheduled_lr(rc, step: int) -> float:
    """The dense tower's rate at `step` under the run's `lr_schedule`."""
    return schedule_lr(rc.lr_schedule, rc.dense_learning_rate, step, rc.steps, rc.warmup_steps)


def dense_step(run_cfg, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               state, lr: float):
    """The dense half of a training step: the grads clipped by the run's
    `grad_clip_norm` where it is set, then the dense Adam at `lr`, in place.
    Returns the new state. Both calls go through this module's attributes,
    so that a wrapper set on them sees every trainer's step."""
    if run_cfg.grad_clip_norm is not None:
        grads = clip_by_global_norm(grads, run_cfg.grad_clip_norm)
    return dense_adam_update(params, grads, state, lr)
