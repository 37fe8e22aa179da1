"""The port's row-kernel and dedup harnesses (`bench.row_kernels`,
`bench.dedup_variants`) against the reference's root scripts
`bench_pallas.py` and `bench_dedup_variants.py`, whose `main()` runs
in-process under JAX on the CPU.

`bench_pallas.py` fixes its shapes in `main()` (a [2^22, 128] plane, 2^19
rows); the test runs its source with that one line set to a [4096, 128]
plane and 256 rows, and the port's harness at the same sizes, and spies
on the reference's `timeit` for the byte counts it passes. Held: the
port's calls in the reference's order under the reference's labels (plus
the kernel set, which the reference does not time), the reference's byte
counts (the donated add, which `main()` prints itself, at three times the
rows moved), the log lines' form, and the bytes bounds.

`bench_dedup_variants.py` reads N, UCAP and STEPS when it loads: both
run at N = 4096. Held: the same id stream; the port's three arms equal,
bit for bit, to the JAX package's `unique_pairs` on it (hi, lo, inverse,
valid), with UCAP below and above the unique count; the unique count the
reference's `main()` prints (which runs only without overflow: its own
set check fails with it) and its B label. Times are not compared: a
CPU run measures the CPU.
"""

import importlib.util
import json
import os
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meepoembedding_tpu_torch.bench import dedup_variants, row_kernels
from meepoembedding_tpu_torch.ops import dedup
from _torch_bench_parity import set_env

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, N = 4096, 256


def _bench_pallas(rows: int, n: int):
    """bench_pallas.py as a module, its shapes set to (rows, n)."""
    path = os.path.join(REPO, "bench_pallas.py")
    src = open(path).read()
    fixed = "R, n = 1 << 22, 1 << 19"
    assert src.count(fixed) == 1
    mod = types.ModuleType("_ref_bench_pallas")
    mod.__file__ = path
    exec(compile(src.replace(fixed, f"R, n = {rows}, {n}"), path, "exec"), mod.__dict__)
    return mod


def test_row_kernels_matches_bench_pallas(capsys):
    ref = _bench_pallas(ROWS, N)
    spied, timeit = [], ref.timeit

    def spy(name, fn, *args, steps=20, bytes_moved=None):
        spied.append((name, bytes_moved))
        return timeit(name, fn, *args, steps=2, bytes_moved=bytes_moved)

    ref.timeit = spy
    capsys.readouterr()
    ref.main()
    ref_lines = capsys.readouterr().err.splitlines()
    got = row_kernels.run(device="cpu", rows=ROWS, n=N, steps=2)
    err = capsys.readouterr().err.splitlines()
    assert err[:2] == ["cpu", ref_lines[0]]  # the card line, then the reference's header

    ref_labels = [line[:40].strip() for line in ref_lines[1:]]
    calls = got["calls"]
    assert [c["reference"] for c in calls if c["reference"]] == ref_labels
    assert [c["label"] for c in calls] == [p for p, _ in row_kernels.LABELS]
    ref_bytes = dict(spied)
    moved = ref_bytes["jnp.take rows"]
    assert moved == N * 128 * 4
    ref_bytes["pallas row_scatter_add (donated)"] = 3 * moved  # printed by main() itself
    for c, line in zip(calls, err[2:]):
        if c["reference"]:
            assert c["ref_bytes"] == ref_bytes[c["reference"]], c["label"]
        assert re.fullmatch(re.escape(f"{c['label']:40s}") + r" +[\d.]+ ms( +[\d.]+ GB/s)?",
                            line), line
        assert ("GB/s" in line) == (c["ref_bytes"] is not None)
        assert c["ms"] > 0 and c["bound_ms"] == pytest.approx(c["bytes"] / 3.35e12 * 1e3)
    assert calls[4]["label"] == "row_scatter_set" and calls[4]["ref_bytes"] == moved
    rows_io = 2 * moved + 4 * N
    assert [c["bytes"] for c in calls[:6]] == [rows_io, rows_io, moved + rows_io, rows_io,
                                               rows_io, moved + rows_io]
    assert json.loads(json.dumps(got)) == got


def _bench_dedup_variants(monkeypatch, ucap: int):
    """bench_dedup_variants.py as a module, loaded at N = 4096 and `ucap`;
    the port's harness reads the same variables."""
    set_env(monkeypatch, {})
    for k, v in (("N", "4096"), ("UCAP", str(ucap)), ("STEPS", "2")):
        monkeypatch.setenv(k, v)
    spec = importlib.util.spec_from_file_location(
        "_ref_bench_dedup_variants", os.path.join(REPO, "bench_dedup_variants.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    return ref


@pytest.mark.parametrize("ucap", [1024, 4096])
def test_dedup_variants_match_jax_unique_pairs(ucap, monkeypatch, capsys):
    ref = _bench_dedup_variants(monkeypatch, ucap)
    hi, lo = dedup_variants.make_stream(4096)
    want_hi, want_lo = ref.make_stream()
    assert np.array_equal(hi, want_hi) and np.array_equal(lo, want_lo)
    u = ref.dedup.unique_pairs(jnp.asarray(hi), jnp.asarray(lo), ucap)
    want = [np.asarray(x) for x in (u.hi, u.lo, u.inverse, u.valid)]
    th, tl = torch.from_numpy(hi), torch.from_numpy(lo)
    cur = dedup.unique_pairs(th, tl, ucap)
    for arm in ((cur.hi, cur.lo, cur.inverse, cur.valid),
                dedup_variants.unique_b(th, tl, ucap),
                dedup_variants.unique_library(th, tl, ucap)):
        for w, g in zip(want, arm):
            assert np.array_equal(g.numpy(), w)
    got = dedup_variants.run(device="cpu")
    assert capsys.readouterr().err.splitlines()[:2] == ["cpu", f"device: cpu, n=4096, ucap={ucap}"]
    assert got["unique"] == int(want[3].sum()) == int(u.count)
    assert (got["unique"] == ucap) == (ucap == 1024)  # the small capacity overflows
    assert all(ms > 0 for ms in got["arms"].values())


def test_dedup_variants_match_bench_dedup_variants(monkeypatch, capsys):
    # the reference's own set check holds only without overflow: UCAP above U
    ref = _bench_dedup_variants(monkeypatch, 4096)
    capsys.readouterr()
    ref.main()
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "device: cpu, n=4096, ucap=4096"
    ref_u = {int(m.group(1)) for m in re.finditer(r"correct \(U=(\d+)\)", "\n".join(out))}
    got = dedup_variants.run(device="cpu")
    err = capsys.readouterr().err.splitlines()
    assert err[1] == out[0]
    assert ref_u == {got["unique"]}
    assert list(got["arms"]) == ["current", "B: searchsorted compaction",
                                 "library: torch.unique"]
    assert sum(line.startswith("B: searchsorted compaction") for line in out) == 1
    assert [line.split(": correct")[0] for line in err if ": correct" in line] == [
        "variant B: searchsorted compaction", "variant library: torch.unique"]
