"""Shared by the port's command-line tests (`tests/test_torch_cli*.py`):
in-process calls of the JAX package's and the port's `main` with their
output captured, checkpoint rows by id, the sizes and tolerances of the
single-table cases, a `serve --http` subprocess of the port, the
reference's `serve --http` on a thread, and worlds of gloo ranks running
the port's `--distributed` command line under torchrun's variables, one
of them serving HTTP from rank 0."""

import contextlib
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

from meepoembedding_tpu import cli as jcli
from meepoembedding_tpu_torch import checkpoint as tckpt
from meepoembedding_tpu_torch import cli as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=0.0, atol=1e-4)
AUC_TOL = 1e-6
# dim 16, 2^14 slots, 4 sparse features, batch 256
SETS = ["run.batch_size=256", "table.capacity=16384", "table.dim=16",
        "model.num_sparse_features=4", "model.num_dense_features=4",
        "model.bottom_mlp=32,16", "model.top_mlp=32,1", "run.log_every=2"]


def data_args(kind: str, criteo_path: str) -> list:
    return {"synthetic": ["--data", "synthetic"], "bags": ["--data", "synthetic", "--bag-len", "3"],
            "criteo": ["--data", criteo_path]}[kind]


def sets_for(kind: str) -> list:
    """SETS, with Criteo's 13 dense and 26 sparse columns for its lines."""
    return SETS + (["model.num_dense_features=13", "model.num_sparse_features=26"]
                   if kind == "criteo" else [])


def call(main, argv):
    """(exit code, stdout, stderr) of one in-process `main(argv)`."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def both(argv, port_argv=None):
    """The reference's and the port's (rc, stdout, stderr) on `argv`."""
    return call(jcli.main, argv), call(tcli.main, (port_argv or argv) + ["--device", "cpu"])


def json_lines(text: str) -> list:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def rows_by_id(path: str) -> dict:
    """A checkpoint's rows sorted by id, every saved array."""
    parts = list(tckpt.iter_rows(path))
    out = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    order = np.argsort(out["ids"])
    return {k: v[order] for k, v in out.items()}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def post(port: int, path: str, body: dict) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


@contextlib.contextmanager
def http_server(argv: list):
    """A `serve --http` subprocess of the port; yields its port once
    /healthz answers, and kills it at exit."""
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "meepoembedding_tpu_torch", "serve", *argv, "--http", str(port),
         "--device", "cpu"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"), cwd=REPO)
    def tail():
        proc.kill()
        return proc.communicate()[1][-3000:]

    try:
        wait_healthy(port, lambda: proc.poll() is None, tail)
        yield port
    finally:
        proc.kill()
        proc.communicate(timeout=30)


def wait_healthy(port: int, alive, tail) -> None:
    """Return once /healthz on `port` answers; raise with `tail()` if the
    server stops (`alive()` false) or 120 s pass."""
    deadline = time.monotonic() + 120
    while True:
        try:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2).read()
            return
        except OSError:
            if not alive() or time.monotonic() > deadline:
                raise AssertionError(f"server never came up: {tail()}")
            time.sleep(0.25)


@contextlib.contextmanager
def reference_http_server(argv: list, monkeypatch):
    """The reference's `serve --http` (`meepoembedding_tpu.cli.main`) on a
    thread of this process; yields its port once /healthz answers, then
    shuts its server down and waits for `main` to return 0."""
    from meepoembedding_tpu import serving as jserving

    made, result = {}, {}
    real = jserving.make_http_server

    def capture(*a, **k):
        made["srv"] = real(*a, **k)
        return made["srv"]

    def run():
        try:
            result["rc"] = jcli.main(["serve", *argv, "--http", str(port)])
        except BaseException as e:  # handed to the test below
            result["error"] = e

    monkeypatch.setattr(jserving, "make_http_server", capture)
    port = free_port()
    th = threading.Thread(target=run, daemon=True)
    th.start()
    try:
        wait_healthy(port, th.is_alive, lambda: repr(result.get("error")))
        yield port
    finally:
        if "srv" in made:
            made["srv"].shutdown()
        th.join(60)
        if "srv" in made:
            made["srv"].server_close()
    assert result == {"rc": 0}, result


def world_env(world: int) -> dict:
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(free_port()), WORLD_SIZE=str(world))


def start_rank(argv: list, base: dict, r: int) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "meepoembedding_tpu_torch", *argv, "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=dict(base, RANK=str(r), LOCAL_RANK=str(r)))


@contextlib.contextmanager
def http_world(argv: list, world: int = 2, timeout: float = 120.0):
    """A world of `world` ranks running `python -m meepoembedding_tpu_torch
    serve --distributed --http PORT <argv> --device cpu` under torchrun's
    variables. Yields {"port": PORT} once rank 0's /healthz answers; at
    exit SIGINT goes to rank 0 alone, every rank must end with 0 within
    `timeout`, and the dict gains "outs", each rank's (exit code, stdout,
    stderr)."""
    state = {"port": free_port()}
    base = world_env(world)
    serve = ["serve", "--distributed", "--http", str(state["port"]), *argv]
    procs = [start_rank(serve, base, r) for r in range(world)]

    def tail():
        for p in procs:
            p.kill()
        return "\n".join(f"rank {r}:\n{p.communicate()[1][-3000:]}" for r, p in enumerate(procs))

    try:
        wait_healthy(state["port"], lambda: all(p.poll() is None for p in procs), tail)
        yield state
        procs[0].send_signal(signal.SIGINT)
        outs = [p.communicate(timeout=timeout) for p in procs]
        state["outs"] = [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (rc, _, err) in enumerate(state["outs"]):
        assert rc == 0, f"rank {r} of {world} ended with {rc}:\n{err[-3000:]}"


def run_world(argv: list, world: int = 2, timeout: float = 120.0) -> list:
    """(exit code, stdout, stderr) of each rank of a world of `world`
    processes running `python -m meepoembedding_tpu_torch <argv> --device
    cpu`, which meet through torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT). Every rank is killed at the
    timeout; a failed rank's traceback is the assertion message."""
    base = world_env(world)
    procs = [start_rank(argv, base, r) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        errs = [p.communicate()[1][-3000:] for p in procs]
        raise AssertionError("world timed out:\n" + "\n".join(
            f"rank {r} of {world}:\n{e}" for r, e in enumerate(errs)))
    for r, (rc, _, err) in enumerate(outs):
        assert rc == 0, f"rank {r} of {world} failed:\n{err[-3000:]}"
    return outs
