"""Pooled multi-hot embedding lookup (port of `meepoembedding_tpu/ops/pooling.py`).

A bag is a fixed `[B, S, L]` id tensor padded with the invalid id. Padding
ids resolve to zero rows in the lookup, so pooling is a plain sum over the
bag, divided by the combiner's count of real ids.

Not in the reference: three bag paths, chosen by the model and by whether
the batch carries the bags' `lengths` [B, S] (a bag's ids are then its
first lengths[b, s] slots).

- Pooled ragged bags (`takes_ragged`: a model that takes pooled bags, such
  as dlrm, dcn, deepfm, ctr_mlp). The table gets only a batch's n valid
  ids (`ragged_batch`), bag by bag in the row-major order of [B, S]: with
  `lengths`, each bag's first lengths[b, s] slots (`ragged_ids`); without
  them, its valid ids wherever the padding lies. `dedup.GatherRows` sums
  each bag's rows straight from the unique rows (`Bags` says which bag each
  id is in) and `pool_bags` applies the combiner to those sums, as bags of
  one row counted by their lengths.
- Positional ragged bags (`takes_positional`: a model that pools inside,
  din and bst, given `lengths`). The table gets the same n valid ids
  (`positional_batch`), and `dedup.GatherRows` lays each id's unique row
  at its (b, s, slot) place of a zero [B, S, L, dim] output (`Positions`
  says where), which the model reads position by position beside the
  bags' validity. The trainer and the scoring service that take such bags
  count the ids taken and the padding slots kept from the table
  (`positional_ids`, `positional_padding`).
- Padded bags: two_tower, which keys items by its padded bags, a model
  that pools inside given no `lengths`, and the sharded and group trainers
  and services. The padded [B, S, L] ids go to the table, padding
  included; `pool_bags` pools them, or the model reads them raw.

On both ragged paths padding never reaches the dedup, the probe or the
update.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from meepoembedding_tpu_torch.table import hashing

COMBINERS = ("sum", "mean", "sqrtn")


def bag_counts(bag_valid: torch.Tensor) -> torch.Tensor:
    """[B, S, L] validity, or ragged bags' lengths [B, S] (integers) ->
    [B, S] f32 count of real ids per bag."""
    if bag_valid.dtype == torch.bool:
        return bag_valid.to(torch.float32).sum(dim=-1)
    return bag_valid.to(torch.float32)


def combine(sums: torch.Tensor, counts: torch.Tensor, combiner: str) -> torch.Tensor:
    """Bags' sums [..., dim] and their f32 counts of real ids [...] -> the
    pooled rows: the sum, the mean, or the sum over the count's root. An
    empty bag pools to zeros under every combiner (the count clamps to 1).
    Each bag's sum is scaled by a factor of its count alone, so the same
    call maps a pooled gradient back to the sums."""
    if combiner not in COMBINERS:
        raise ValueError(f"combiner must be one of {COMBINERS}, got {combiner!r}")
    if combiner == "sum":
        return sums
    cnt = counts.clamp(min=1.0)
    if combiner == "mean":
        return sums / cnt[..., None]
    return sums / torch.sqrt(cnt)[..., None]


def pool_bags(emb: torch.Tensor, bag_valid: torch.Tensor, combiner: str) -> torch.Tensor:
    """[B, S, L, dim] rows (zero under padding) -> [B, S, dim], `bag_valid`
    as `bag_counts` takes it. Both bag paths pool here (ragged bags as
    their sums [B, S, 1, dim] and lengths), so a change of the combiner
    shows on both."""
    return combine(emb.sum(dim=2), bag_counts(bag_valid), combiner)


def pool_or_reshape(emb_flat: torch.Tensor, ids_shape, bag_valid, dim: int,
                    combiner: str) -> torch.Tensor:
    """[n, dim] gathered rows (batch order) -> [B, S, dim] model inputs for
    one-hot [B, S] and multi-hot [B, S, L] id batches."""
    emb = emb_flat.reshape(tuple(ids_shape) + (dim,))
    if len(ids_shape) == 2:
        return emb
    return pool_bags(emb, bag_valid, combiner)


class Bags(NamedTuple):
    """Ragged bags on the device, for `dedup.GatherRows`."""

    of: torch.Tensor  # i32 [n] the bag of each id (its row-major index in [B, S]), sorted
    lengths: torch.Tensor  # i32 [B, S]
    combiner: str


class Positions(NamedTuple):
    """Positional ragged bags on the device, for `dedup.GatherRows`."""

    at: torch.Tensor  # i32 [n] each id's flat place in [B, S, L], increasing
    valid: torch.Tensor  # bool [B, S, L] the places that hold an id


def _bags_of(ids) -> bool:
    ndim = ids.dim() if isinstance(ids, torch.Tensor) else np.ndim(ids)
    return ndim == 3


def takes_ragged(model, ids) -> bool:
    """Whether a batch's ids go the pooled ragged way: multi-hot [B, S, L]
    bags for a model that takes them pooled. Models that pool inside (din,
    bst) or key items by their padded bags (two_tower) do not."""
    return (_bags_of(ids) and not getattr(model, "pools_inside", False)
            and not hasattr(model, "item_key"))


def takes_positional(model, ids, lengths) -> bool:
    """Whether a batch's ids go the positional ragged way: multi-hot
    [B, S, L] bags with their `lengths` for a model that pools inside (din,
    bst). Without `lengths` such a model keeps the padded bags."""
    return (_bags_of(ids) and lengths is not None and getattr(model, "pools_inside", False)
            and not hasattr(model, "item_key"))


def _host(x, dtype) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, dtype)


@functools.lru_cache(maxsize=8)
def _slots(rows: int, S: int, L: int, width: tuple):
    """The flat positions in [rows, S, L] of each feature's first width[s]
    slots, [rows, K] in the row-major order of [rows, S] (read-only; its
    first B rows serve a batch of B), and the feature and slot of each of
    the K columns: a function of the shape and the widths alone, which a
    stream's batches share."""
    w = np.asarray(width, np.int64)
    feat = np.repeat(np.arange(S), w)
    slot = np.arange(len(feat)) - (np.cumsum(w) - w)[feat]
    at = (torch.arange(0, rows * S * L, S * L)[:, None]
          + torch.from_numpy(feat * L + slot)[None, :])
    return at, feat, slot


def ragged_ids(ids, lengths, pin: bool = False) -> torch.Tensor:
    """The n = sum(lengths) ids of [B, S, L] padded bags whose lengths
    [B, S] are given, flat, bag by bag in the row-major order of [B, S]: a
    CPU tensor, in pinned memory with `pin`. A bag's ids are its first
    lengths[b, s] slots. Per feature, the slots up to its longest bag in the
    batch are taken by one `torch.take` (all of a feature's ids where its
    bags have one size, as fixed-size multi-hot features have); the slots
    past a bag's length are dropped only where some bag is shorter. The
    padded array is never copied whole."""
    ids, lens = _host(ids, np.int64), _host(lengths, np.int64)
    if ids.ndim != 3 or lens.shape != ids.shape[:2]:
        raise ValueError(f"ragged bags need ids [B, S, L] and lengths [B, S]; got ids "
                         f"{ids.shape} and lengths {lens.shape}")
    B, S, L = ids.shape
    width = lens.max(axis=0) if B else np.zeros(S, np.int64)
    if B and (width.max() > L or lens.min() < 0):
        raise ValueError(f"bag lengths must lie in [0, {L}]")
    at, feat, slot = _slots(1 << max(0, B - 1).bit_length(), S, L, tuple(width.tolist()))
    at = at[:B]
    if not (lens == width[None, :]).all():
        at = at[torch.from_numpy(slot[None, :] < lens[:, feat])]
    out = torch.empty(at.numel(), dtype=torch.int64, pin_memory=pin)
    return torch.take(torch.from_numpy(ids), at.reshape(-1), out=out)


def fixed_bag_ids(ids: np.ndarray, widths: tuple, out: torch.Tensor) -> torch.Tensor:
    """`ragged_ids` of [C, S, L] int64 bags whose lengths are `widths` on
    every row (each in [0, L], which the caller has checked), written into
    `out`, a [C * sum(widths)] int64 CPU tensor, and returned: fixed-size
    bags, which need no check of their lengths and no buffer of their own
    (a scoring request's)."""
    c, s, l = ids.shape
    at = _slots(1 << max(0, c - 1).bit_length(), s, l, widths)[0][:c]
    return torch.take(torch.from_numpy(ids), at.reshape(-1), out=out)


def ragged_batch(ids, lengths, device, combiner: str):
    """[B, S, L] padded bags -> (their n valid ids on `device`, flat, bag by
    bag in the row-major order of [B, S]; their `Bags`). With `lengths`
    [B, S] a bag's ids are its first lengths[b, s] slots (`ragged_ids`, the
    host's copy pinned for a CUDA device); without, its valid ids wherever
    the padding lies, and lengths their count."""
    if lengths is None:
        t = ids if isinstance(ids, torch.Tensor) else torch.from_numpy(_host(ids, np.int64))
        valid = hashing.is_valid(*hashing.split_ids_t(t))
        flat, lengths = t[valid].to(device), valid.sum(dim=-1, dtype=torch.int32)
    else:
        pin = torch.device(device).type == "cuda"
        flat = ragged_ids(ids, lengths, pin).to(device, non_blocking=pin)
    return flat, bags_on(lengths, flat.shape[0], device, combiner)


def bags_on(lengths, n: int, device, combiner: str) -> Bags:
    """The `Bags` of lengths [B, S] holding n ids in all, on `device`."""
    if combiner not in COMBINERS:
        raise ValueError(f"combiner must be one of {COMBINERS}, got {combiner!r}")
    lens = torch.as_tensor(lengths).to(device=device, dtype=torch.int32)
    bag = torch.arange(lens.numel(), dtype=torch.int32, device=device)
    of = torch.repeat_interleave(bag, lens.reshape(-1), output_size=n)
    return Bags(of=of, lengths=lens, combiner=combiner)


def positional_batch(ids, lengths, device):
    """[B, S, L] padded bags and their lengths [B, S] -> (their n =
    sum(lengths) valid ids on `device`, flat, bag by bag in the row-major
    order of [B, S]; their `Positions`). The padded ids and the lengths are
    copied as they are, without waiting on the device (a copy from pageable
    memory is staged before it returns); on the device the validity is made
    from the lengths and the valid places are taken from it at the size n,
    which the host knows. Only the n valid ids go on to the split, the
    dedup, the probe and the update."""
    ids, lens = _host(ids, np.int64), _host(lengths, np.int64)
    if ids.ndim != 3 or lens.shape != ids.shape[:2]:
        raise ValueError(f"positional bags need ids [B, S, L] and lengths [B, S]; got ids "
                         f"{ids.shape} and lengths {lens.shape}")
    L = ids.shape[2]
    if lens.size and (lens.min() < 0 or lens.max() > L):
        raise ValueError(f"bag lengths must lie in [0, {L}]")
    valid = (torch.arange(L, device=device)
             < torch.from_numpy(lens).to(device, non_blocking=True).unsqueeze(-1))
    at = torch.nonzero_static(valid.reshape(-1), size=int(lens.sum())).reshape(-1)
    flat = torch.from_numpy(ids).to(device, non_blocking=True).reshape(-1).index_select(0, at)
    return flat, Positions(at=at.to(torch.int32), valid=valid)
