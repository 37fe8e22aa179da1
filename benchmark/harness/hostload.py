"""What the host did while the window ran, for the look behind a run's speed:
the cores this process kept busy, its context switches, the share of all
cores' time that the hypervisor stole or that sat idle, and the cores'
clock. Read from getrusage and /proc; a counter that did not move (a
sandboxed kernel may keep them at 0) is left out.
"""

from __future__ import annotations

import os
import resource
import time


def _cpu_times():
    try:
        with open("/proc/stat") as f:
            return [int(x) for x in f.readline().split()[1:9]]
    except (OSError, ValueError):
        return None


def _mhz():
    try:
        with open("/proc/cpuinfo") as f:
            v = [float(line.split(":")[1]) for line in f if line.startswith("cpu MHz")]
        return sum(v) / len(v) if v else None
    except (OSError, ValueError):
        return None


def snapshot() -> dict:
    return {"t": time.perf_counter(), "cpu": _cpu_times(),
            "ru": resource.getrusage(resource.RUSAGE_SELF)}


def describe(a: dict, b: dict) -> str:
    """One line on the host between snapshots a and b."""
    wall = b["t"] - a["t"]
    ru0, ru1 = a["ru"], b["ru"]
    busy = (ru1.ru_utime + ru1.ru_stime - ru0.ru_utime - ru0.ru_stime) / wall
    parts = [f"this process kept {busy:.3f} cores busy"]
    inv, vol = ru1.ru_nivcsw - ru0.ru_nivcsw, ru1.ru_nvcsw - ru0.ru_nvcsw
    if inv or vol:
        parts.append(f"{inv} involuntary and {vol} voluntary context switches")
    if a["cpu"] and b["cpu"]:
        d = [y - x for x, y in zip(a["cpu"], b["cpu"])]
        if sum(d):
            parts.append(f"of {os.cpu_count()} cores' time {d[7] / sum(d):.4f} stolen, "
                         f"{(d[3] + d[4]) / sum(d):.4f} idle")
    mhz = _mhz()
    if mhz:
        parts.append(f"cpu MHz {mhz:.0f}")
    parts.append(f"{len(os.sched_getaffinity(0))} cores allowed")
    return "host in the window: " + "; ".join(parts)
