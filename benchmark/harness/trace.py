"""Reading a profiler trace (the Chrome trace `torch.profiler` exports):
the device's busy time in a window, the device time of each layer, the
longest-running device operations and what the host did while the device
sat idle.

A device operation (kernel, memcpy, memset) is tied to the host thread that
launched it through the runtime call with the same correlation id. Its layer
is that of the innermost host range around the launch that a rule names
(`instrument.RULES`: the benchmark's own annotations around the port's
calls, and the autograd engine's backward nodes). A device operation under
no such range is left to no layer.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
from typing import Callable, Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("user_annotation", "cpu_op")


@dataclasses.dataclass
class Timeline:
    window_us: Tuple[float, float]
    busy_us: float
    layer_us: Dict[str, float]  # device time by layer; "" = no layer
    device_ops: List[Tuple[str, float]]  # (name, us), longest first
    idle_gaps: List[Tuple[str, float]]  # (host activity, us), longest first
    launches: int

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return self.busy_us / 1e6


def load(path: str) -> List[dict]:
    with open(path) as f:
        d = json.load(f)
    return d["traceEvents"] if isinstance(d, dict) else d


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _enclosing(ranges: List[Tuple[float, float, str]], queries: List[float]
               ) -> List[List[str]]:
    """For each query time, the names of the ranges of one thread that hold
    it, outermost first. `ranges` are (start, end, name), nested or apart."""
    order = sorted(range(len(queries)), key=lambda i: queries[i])
    rs = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out: List[List[str]] = [[] for _ in queries]
    stack: List[Tuple[float, float, str]] = []
    j = 0
    for i in order:
        t = queries[i]
        while j < len(rs) and rs[j][0] <= t:
            while stack and stack[-1][1] < rs[j][0]:
                stack.pop()
            stack.append(rs[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = [r[2] for r in stack if r[0] <= t <= r[1]]
    return out


def timeline(events: List[dict], layer_of: Callable[[str], Optional[str]],
             window: str = "bench.window", top: int = 10) -> Timeline:
    """Reduce trace events to a `Timeline` over the host range `window`."""
    win = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
           and e.get("name") == window]
    if not win:
        raise ValueError(f"no {window!r} range in the trace")
    w = win[0]
    w0, w1, main_tid = float(w["ts"]), float(w["ts"]) + float(w["dur"]), w["tid"]
    launch = {}
    host: Dict[object, List[Tuple[float, float, str]]] = collections.defaultdict(list)
    device = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            device.append(e)
        elif cat in RUNTIME_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = (e["tid"], float(e["ts"]))
            host[e["tid"]].append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                                   e["name"]))
        elif cat in HOST_CATS:
            host[e["tid"]].append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                                   e["name"]))
    # each device op's layer, from the host ranges around its launch
    by_tid: Dict[object, List[int]] = collections.defaultdict(list)
    for k, e in enumerate(device):
        at = launch.get((e.get("args") or {}).get("correlation"))
        if at is not None:
            by_tid[at[0]].append(k)
    layer = [""] * len(device)
    for tid, ks in by_tid.items():
        names = _enclosing(host[tid], [launch[device[k]["args"]["correlation"]][1]
                                       for k in ks])
        for k, stack in zip(ks, names):
            for name in reversed(stack):
                lay = layer_of(name)
                if lay:
                    layer[k] = lay
                    break
    layer_us: Dict[str, float] = collections.defaultdict(float)
    ops: Dict[str, float] = collections.defaultdict(float)
    iv = []
    for k, e in enumerate(device):
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        iv.append((a, b))
        layer_us[layer[k]] += b - a
        ops[e["name"][:160]] += b - a
    busy = _merge(iv)
    busy_us = sum(b - a for a, b in busy)
    # the idle gaps
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    # each gap split where the main thread's host ranges start or end, each
    # piece named by the innermost range open over it
    marks = sorted({t for a, b, _ in host[main_tid] for t in (a, b)})
    pieces = []
    for a, b in gaps:
        pts = [a] + marks[bisect.bisect_right(marks, a):bisect.bisect_left(marks, b)] + [b]
        pieces += [(p, q) for p, q in zip(pts, pts[1:]) if q > p]
    named = _enclosing(host[main_tid], [(p + q) / 2 for p, q in pieces])
    idle: Dict[str, float] = collections.defaultdict(float)
    for (p, q), stack in zip(pieces, named):
        inner = [n for n in stack if n != window]
        idle[inner[-1] if inner else "host outside any op"] += q - p
    top_ops = sorted(ops.items(), key=lambda x: -x[1])[:top]
    top_gaps = sorted(idle.items(), key=lambda x: -x[1])[:top]
    return Timeline(window_us=(w0, w1), busy_us=busy_us, layer_us=dict(layer_us),
                    device_ops=top_ops, idle_gaps=top_gaps, launches=len(iv))


@dataclasses.dataclass
class Reading:
    """What a per-layer metric's reader gets: the traced window's timeline
    and the work done in it."""

    timeline: Timeline
    units: int  # training steps or requests completed in the traced window
    kind: str  # the device's name, for its peaks
    flops_per_unit: float = 0.0
    table_bytes_per_unit: float = 0.0

    def layer_ms_per_unit(self, layer: str) -> Optional[float]:
        us = self.timeline.layer_us.get(layer, 0.0)
        if not us or not self.units:
            return None
        return us / 1e3 / self.units

    def idle_pct(self) -> Optional[float]:
        if self.timeline.busy_us <= 0:
            return None
        return 100.0 * (1.0 - self.timeline.busy_s / self.timeline.window_s)
