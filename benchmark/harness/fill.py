"""The set-up's fill: every id of the configuration's vocabulary, with rows
made from the seed on the device.

Ids are namespaced per feature, id = feature << 44 | value, as the port's
`data/synthetic.py` makes them, with value in [0, cardinality). The fill
goes feature by feature in chunks of `CHUNK` ids; chunk c's rows are the
c-th `torch.rand` call of one generator, scaled to U(-scale, scale). The
reference makes the rows of any id again by replaying the same calls
(`rows_at`). Frozen from the idea of `meepoembedding_tpu_torch/bench/
_common.py`'s `prefill` (ids in batches into the table), with explicit rows
in place of the table's own init, so that the reference needs nothing the
program made.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from harness import seeds

FEATURE_SHIFT = 44
CHUNK = 1 << 20


def offsets(cards: Sequence[int]) -> np.ndarray:
    """[F + 1] int64: feature f's ids are fill positions offsets[f] .. offsets[f+1]."""
    return np.concatenate([[0], np.cumsum(np.asarray(cards, np.int64))])


def ids_of_positions(pos: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Fill positions -> namespaced int64 ids (off from `offsets`, on pos's device)."""
    f = torch.searchsorted(off[1:], pos, right=True)
    return (f << FEATURE_SHIFT) | (pos - off[f])


def positions_of_ids(ids: np.ndarray, cards: Sequence[int]) -> np.ndarray:
    """Namespaced ids -> fill positions, -1 for an id outside the vocabulary
    (a first sighting or an unknown id)."""
    ids = np.asarray(ids, np.int64)
    f = ids >> FEATURE_SHIFT
    v = ids & ((1 << FEATURE_SHIFT) - 1)
    c = np.asarray(cards, np.int64)
    ok = (f >= 0) & (f < len(c))
    fc = np.where(ok, f, 0)
    ok &= v < c[fc]
    return np.where(ok, offsets(cards)[fc] + v, -1)


def _rows(g: torch.Generator, n: int, dim: int, scale: float, device) -> torch.Tensor:
    return (torch.rand((n, dim), generator=g, device=device) * 2.0 - 1.0) * scale


def fill(assign: Callable[[torch.Tensor, torch.Tensor], int], cards: Sequence[int], dim: int,
         scale: float, seed: int, device) -> int:
    """Hand every vocabulary id and its row to `assign(ids, rows)`, which
    returns how many landed; returns the total landed."""
    off_np = offsets(cards)
    off = torch.from_numpy(off_np).to(device)
    g = seeds.torch_gen(seed, "fill", device)
    landed = 0
    for a in range(0, int(off_np[-1]), CHUNK):
        b = min(a + CHUNK, int(off_np[-1]))
        pos = torch.arange(a, b, dtype=torch.int64, device=device)
        landed += assign(ids_of_positions(pos, off), _rows(g, b - a, dim, scale, device))
    return landed


def rows_at(pos: np.ndarray, cards: Sequence[int], dim: int, scale: float, seed: int,
            device) -> torch.Tensor:
    """[len(pos), dim] f32 fill rows at fill positions `pos` (all >= 0), made
    again by replaying the fill's calls up to the last chunk needed."""
    pos = np.asarray(pos, np.int64)
    out = torch.empty((len(pos), dim), dtype=torch.float32, device=device)
    if len(pos) == 0:
        return out
    total = int(offsets(cards)[-1])
    g = seeds.torch_gen(seed, "fill", device)
    chunk_of = pos // CHUNK
    for c in range(int(chunk_of.max()) + 1):
        a = c * CHUNK
        rows = _rows(g, min(CHUNK, total - a), dim, scale, device)
        (sel,) = np.nonzero(chunk_of == c)
        if len(sel):
            at = torch.from_numpy(sel).to(device)
            out[at] = rows[torch.from_numpy(pos[sel] - a).to(device)]
    return out
