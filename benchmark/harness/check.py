"""The numbers that decide `correct`, and how they are printed.

Each number has a limit in the cell's file (`cells/<workload>.json`,
`limits`), or is named there under `not_compared` (a number with no
reading that could fail it; PERF.md gives its readings). A run is correct
when every compared number is at most its limit. The compared numbers are
printed, each beside its limit, as the last lines on standard error and
under the result line's last key; the others are printed before them."""

from __future__ import annotations

import math
import sys
from typing import Dict, Sequence

import numpy as np


def rel_gap(a: float, b: float) -> float:
    """|a - b| / |b|."""
    return abs(a - b) / abs(b) if b else (0.0 if a == b else math.inf)


def leaf_gaps(prog: Sequence[float], ref: Sequence[float], keep=None) -> np.ndarray:
    """Per leaf, the gap between the program's and the reference's norm,
    over the larger of the reference's norm of that leaf and of the median
    leaf; leaves with `keep` False are left out."""
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    keep = np.ones(len(ref), bool) if keep is None else np.asarray(keep, bool)
    med = float(np.median(ref))
    gaps = np.abs(prog - ref) / np.maximum(ref, med)
    return np.where(np.isfinite(prog), gaps, np.inf)[keep]


def worst_leaf(prog, ref, keep=None) -> float:
    """The widest of `leaf_gaps`."""
    g = leaf_gaps(prog, ref, keep)
    return float(g.max()) if len(g) else 0.0


def median_leaf(prog, ref, keep=None) -> float:
    """The median of `leaf_gaps`: steady where single small leaves are not."""
    g = leaf_gaps(prog, ref, keep)
    return float(np.median(g)) if len(g) else 0.0


def verdict(numbers: Dict[str, float], limits: Dict[str, float],
            not_compared: Sequence[str] = ()) -> bool:
    """True when every compared number is finite and at most its limit; a
    number with neither a limit nor a place in `not_compared` fails."""
    return all(k in limits and math.isfinite(v) and v <= limits[k]
               for k, v in numbers.items() if k not in not_compared)


def report(numbers: Dict[str, float], limits: Dict[str, float],
           not_compared: Sequence[str] = ()) -> dict:
    """{name: {"value", "limit"}} of the compared numbers for the result
    line, printed on stderr after the numbers not compared."""
    for k in not_compared:
        if k in numbers:
            print(f"not compared: {k} = {float(numbers[k])!r}", file=sys.stderr, flush=True)
    out = {k: {"value": float(v), "limit": limits.get(k)} for k, v in numbers.items()
           if k not in not_compared}
    for k, d in out.items():
        print(f"check {k} = {d['value']!r} limit {d['limit']!r}", file=sys.stderr, flush=True)
    return out
