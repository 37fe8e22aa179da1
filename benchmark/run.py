"""Run one cell of the benchmark once and print its result line.

  python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's cards. The cell,
its configuration, traffic mix and metrics are found by name (see
`harness/spec.py`). Set-up (imports, the kernels' build on a checkout's first
run, weights, the table's fill, the first steps, warm-up) is timed from the
process's start to the window's; the window then runs for `--seconds`
(`--trace 1`: at most `TRACE_SECONDS`, under the profiler, reporting the
per-layer metrics). After the window the program's state is freed and the
plain reference (`reference/`) checks what the window's path produced;
`correct` is the verdict, and each number compared is printed beside its
limit on stderr and last in the result line. The last line of stdout is the
result as one JSON object. Without enough CUDA devices the run exits 2 and
prints no result; if the JAX package or JAX is loaded, it exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(HERE), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TRACE_SECONDS = 3.0
FORBIDDEN = ("jax", "jaxlib", "flax", "meepoembedding_tpu")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: `meepoembedding_tpu_torch` is not
    `meepoembedding_tpu`."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "?"


def profiled(fn, annotate):
    """(fn's result, trace.Timeline) of fn run under the profiler inside the
    host range "bench.window", within the context `annotate()` (the port's
    calls annotated by layer, or nothing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from harness import instrument, trace

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        with annotate():
            with record_function("bench.window"):
                out = fn()
    torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", dir=os.environ.get("TMPDIR"))
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = trace.load(path)
    finally:
        os.remove(path)
    return out, trace.timeline(events, instrument.layer_of)


def warm_profiler(fn) -> None:
    """Start and stop the profiler once around `fn`, so that its own start-up
    (CUPTI) falls in set-up."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        fn()


def per_layer(cell, reading) -> dict:
    out = {}
    for m in cell.per_layer:
        v = cell.reader(m.name)(reading)
        if v is not None:
            out[m.name] = {"value": float(v), "unit": m.unit}
    return out


def breakdown(tl) -> dict:
    return {"device_ops": [[n, us / 1e6] for n, us in tl.device_ops],
            "idle_gaps": [[n, us / 1e6] for n, us in tl.idle_gaps]}


def free_device(dev) -> int:
    """The device's peak allocated bytes; then its cached blocks are freed."""
    import torch

    gc.collect()
    if dev.type != "cuda":
        return 0
    peak = int(torch.cuda.max_memory_allocated(dev))
    torch.cuda.empty_cache()
    return peak


def run_train(cell, seed: int, seconds: float, traced: bool, dev) -> dict:
    from harness import hostload, instrument, train_cell, work
    from harness.trace import Reading

    tc = train_cell.TrainCell(cell, seed, dev)
    prog = tc.first_steps()
    tc.warm()
    if traced:
        warm_profiler(lambda: tc.warm(1))
    setup_s = time.perf_counter() - T_START
    log(f"set-up {setup_s:.3f} s; window {seconds} s")
    res = {}
    if traced:
        w, tl = profiled(lambda: tc.window(seconds), instrument.annotate)
        feed, cfg = tc.feed, cell.config
        nbytes = [work.table_step_bytes(feed.ids_per_batch, feed.unique_per_step(s),
                                        feed.fresh_per_step(s), cfg["model"]["embedding_dim"],
                                        n_bags=feed.bags_per_batch)
                  for s in range(w["first_step"], w["first_step"] + w["steps"])]
        reading = Reading(tl, w["steps"], torch_kind(),
                          flops_per_unit=work.train_flops_per_example(cfg) * cell.mix["batch"],
                          table_bytes_per_unit=sum(nbytes) / len(nbytes))
        res["metrics"] = per_layer(cell, reading)
        res["timeline"] = tl
    else:
        h0 = hostload.snapshot()
        w = tc.window(seconds)
        log(hostload.describe(h0, hostload.snapshot()))
        res["metrics"] = {"setup_s": {"value": setup_s, "unit": "s"},
                          "train_ids_per_s": {"value": w["ids"] / w["seconds"],
                                              "unit": "ids/s"}}
    log(f"window: {w['steps']} steps in {w['seconds']:.3f} s; by quarter {w['quarters']}")
    res["attempted"], res["failed"] = w["steps"], tc.failed
    batches = tc.batches
    tc.free()
    res["memory_peak_bytes"] = free_device(dev)
    refr = train_cell.reference_readings(cell.config, seed, batches, dev)
    res["numbers"] = train_cell.compare(prog, refr)
    return res


def run_serve(cell, seed: int, seconds: float, traced: bool, dev) -> dict:
    import numpy as np
    from torch.profiler import record_function

    from harness import hostload, serve_cell
    from harness.trace import Reading

    sc = serve_cell.ServeCell(cell, seed, dev, seconds)
    if traced:
        warm_profiler(lambda: sc.warm())
    setup_s = time.perf_counter() - T_START
    log(f"set-up {setup_s:.3f} s; window {seconds} s, {len(sc.sched)} requests due")
    res = {}
    if traced:
        # the whole of `score` is the serving layer: no finer ranges inside
        w, tl = profiled(lambda: sc.window(seconds, annotate=record_function),
                         contextlib.nullcontext)
        reading = Reading(tl, w["answered"], torch_kind())
        res["metrics"] = per_layer(cell, reading)
        res["timeline"] = tl
    else:
        h0 = hostload.snapshot()
        w = sc.window(seconds)
        log(hostload.describe(h0, hostload.snapshot()))
        res["metrics"] = {"setup_s": {"value": setup_s, "unit": "s"},
                          "serve_candidates_per_s": {
                              "value": w["candidates_in_window"] / seconds,
                              "unit": "candidates/s"}}
    by_quarter = np.histogram(w["done_s"], bins=np.linspace(0.0, seconds, 5))[0].tolist()
    log(f"window: {w['answered']} of {w['started']} requests started answered, {w['failed']} "
        f"failed, {int((w['done_s'] <= seconds).sum())} in the window (by quarter {by_quarter}); "
        f"{w['backlog']} requests due and not started at the close")
    res["attempted"], res["failed"] = w["started"], w["failed"]
    prog, inputs, dropped = sc.answers()
    sc.free()
    res["memory_peak_bytes"] = free_device(dev)
    refr = serve_cell.reference_scores(cell.config, seed, inputs, dev)
    res["numbers"] = serve_cell.compare(prog, refr, w["failed"], dropped)
    return res


def torch_kind() -> str:
    import torch

    return torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import check, spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"{args.workload} needs {cell.chips} CUDA device(s); {n} visible")
        return 2
    log(f"card: {card_line()}")
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    traced = bool(args.trace)
    seconds = min(args.seconds, TRACE_SECONDS) if traced else args.seconds
    drive = {"closed": run_train, "open": run_serve}[cell.loop]
    res = drive(cell, args.seed, seconds, traced, dev)
    bad = forbidden_modules(sys.modules)
    if bad:
        log(f"refused: modules of the JAX package or JAX are loaded: {bad}")
        return 3
    correct = check.verdict(res["numbers"], cell.limits, cell.not_compared)
    device = {"platform": "gpu", "kind": torch_kind(), "count": cell.chips,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"correct": correct, "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": res["metrics"], "device": device}
    if traced:
        tl = res["timeline"]
        device["busy_s"], device["window_s"] = tl.busy_s, tl.window_s
        out["breakdown"] = breakdown(tl)
    out["checks"] = check.report(res["numbers"], cell.limits, cell.not_compared)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
