"""The port's table harnesses (`meepoembedding_tpu_torch/bench/`: headline,
phases, stages, evict, ckpt_full) against the reference's root scripts.

Each reference script's `main()` runs in-process under JAX on the CPU with
the same `MEEPO_*` values as the port's `run(device="cpu")`; both print
the same log lines on stderr and the same JSON keys, which the tests
parse. Exact: the headline's auto-sized dedup capacity and its sample's
uniques, the warm-up step's uniques and the dynamic arm's counters (hits,
misses, inserts, drops); evict's live rows, rows evicted in the
candidate-rich passes and in the windowed ones; the step and stage names,
in the reference's order. The checkpoint the port's ckpt_full writes
restores into the JAX package with every row bit-exact, and a save cut
after its first part resumes without fetching that part again; the
headline's init watchdog prints the reference's error line and exits 3.
Times are not compared: a CPU run measures the CPU.

`test_row_merge_add_never_sees_a_row_twice` runs every harness here
through a wrapper of `kernels.row_merge_add` that fails on a repeated
enabled row: on the card such rows race, while the plain version on the
CPU sums them correctly, so only the wrapper can see the fault.
`test_chip_smoke_holds_every_harness_kernel_call` runs the headline
through `chip_smoke.held_kernels`, which holds the harnesses' kernel calls
against the plain versions on the card.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meepoembedding_tpu import checkpoint as jckpt
from meepoembedding_tpu.config import OptimizerConfig as JOptimizerConfig
from meepoembedding_tpu.config import TableConfig as JTableConfig
from meepoembedding_tpu.table.layout import TableSpec as JTableSpec
from meepoembedding_tpu_torch import checkpoint as tckpt
from meepoembedding_tpu_torch import kernels
from meepoembedding_tpu_torch.bench import ckpt_full, evict, headline, phases, stages
from meepoembedding_tpu_torch.table import table_ops
from _torch_bench_parity import REPO, both, reference, set_env, unique_rows_only  # noqa: F401

torch.set_num_threads(1)

HEADLINE = {"MEEPO_BENCH_CAP": "16384", "MEEPO_BENCH_BATCH": "2048", "MEEPO_BENCH_STEPS": "3"}
HEADLINE_CASES = {
    "zipf": {},
    "mixture": {"MEEPO_BENCH_ZIPF": "0"},  # the two-uniform stream, ucap = batch
    "drops": {"MEEPO_BENCH_FILL": "0.97"},  # bucket pairs overflow: inserts drop
}
PHASES = {"MEEPO_BENCH_CAP": "16384", "MEEPO_BENCH_BATCH": "2048", "MEEPO_BENCH_STEPS": "3",
          "MEEPO_BENCH_WINDOWS": "2"}
STAGES = {"MEEPO_BENCH_CAP": "16384", "MEEPO_BENCH_BATCH": "2048"}
EVICT = {"MEEPO_BENCH_CAP": "32768", "MEEPO_EVICT_REPS": "3", "MEEPO_EVICT_WINDOW": "64"}
CKPT = {"MEEPO_BENCH_CAP": "32768", "MEEPO_CKPT_SAMPLE": "1000",
        "MEEPO_CKPT_CHUNK_ROWS": "8192"}


def _find(pattern: str, text: str) -> tuple:
    m = re.search(pattern, text, re.M)
    assert m, f"{pattern!r} not in:\n{text}"
    return m.groups()


@pytest.mark.parametrize("case", sorted(HEADLINE_CASES))
def test_headline_matches_bench_py(case, monkeypatch, capsys):
    lines, err, got, terr = both("bench", headline, {**HEADLINE, **HEADLINE_CASES[case]},
                                monkeypatch, capsys)
    want = lines[-1]
    assert list(got) == list(want) == ["metric", "value", "unit", "vs_baseline",
                                       "vs_sol_unique"]
    assert got["metric"] == want["metric"] and got["unit"] == want["unit"]
    assert got["value"] > 0 and got["vs_baseline"] > 0 and got["vs_sol_unique"] > 0
    assert terr.splitlines()[0] == "cpu"  # the card line comes first
    ucap_line = r"ucap auto-sized: (\d+) observed uniques -> cap (\d+)"
    if case == "mixture":
        assert not re.search(ucap_line, err) and not re.search(ucap_line, terr)
    else:
        assert _find(ucap_line, terr) == _find(ucap_line, err)
    uniques = r"uniques/step ~(\d+) \(ucap (\d+)\)"
    assert _find(uniques, terr) == _find(uniques, err)
    counters = r"counters: hits=(\d+) misses=(\d+) inserts=(\d+) drops=(\d+)"
    assert _find(counters, terr) == _find(counters, err)
    if case == "drops":
        assert int(_find(counters, err)[3]) > 0


def _timed_names(err: str, fmt: str) -> list:
    """The step names of the reference's timing lines, in order."""
    return [m.group(1).rstrip() for m in re.finditer(fmt, err, re.M)]


def test_phases_names_match_bench_phases(monkeypatch, capsys):
    _, err, got, terr = both("bench_phases", phases, PHASES, monkeypatch, capsys)
    ref_names = _timed_names(err, r"^(.{40}) +[\d.]+ ms   \[")
    assert [p["reference"] for p in got["phases"]] == ref_names
    assert len(ref_names) == 9
    assert [p["name"] for p in got["phases"]] == _timed_names(terr, r"^(.{40}.*?) +[\d.]+ ms   \[")
    assert all(p["ms"] > 0 for p in got["phases"])


def test_stages_names_match_bench_stages(monkeypatch, capsys):
    _, err, got, terr = both("bench_stages", stages, STAGES, monkeypatch, capsys)
    ref_names = _timed_names(err, r"^(.{34}) +[\d.]+ ms$")
    n = len(got["stages"])
    assert [s["reference"] for s in got["stages"]] == ref_names[:n]
    assert [s["name"] for s in got["stages"]] == _timed_names(terr, r"^(.{34}.*?) +[\d.]+ ms$")
    # the rest are the reference's TPU sub-stages: named, with no time
    assert len(ref_names) == n + 5
    tpu_line = _find(r"^(.*no counterpart in the port)$", terr)[0]
    for name in ref_names[n:]:
        assert name.strip().split(" (")[0] in tpu_line, name


def test_evict_matches_bench_evict(monkeypatch, capsys):
    lines, err, got, terr = both("bench_evict", evict, EVICT, monkeypatch, capsys)
    want = lines[-1]
    assert list(got) == list(want)
    for k in ("metric", "capacity", "dim", "dtype", "live_rows", "window_buckets",
              "max_evict_per_pass", "evicted_rich"):
        assert got[k] == want[k], k
    assert got["evicted_rich"] == got["live_rows"] > 0  # the TTL expired every row
    window = r"K=64 window +best +[\d.]+ ms \(evicted (\d+)\)"
    assert _find(window, terr) == _find(window, err)


def test_ckpt_full_restores_into_jax_bit_exact(tmp_path, monkeypatch, capsys):
    knobs = {**CKPT, "MEEPO_CKPT_DIR": str(tmp_path / "ref")}
    set_env(monkeypatch, knobs)
    reference("bench_ckpt_full").main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    path = str(tmp_path / "port")
    got = ckpt_full.run(device="cpu", ckpt_dir=path)
    assert list(got) == list(want)
    assert got["rows"] == want["rows"] and got["sample_bit_exact"] is True
    # the port's checkpoint in the JAX package: every row, bit for bit
    jspec = JTableSpec.from_config(JTableConfig(
        dim=32, capacity=32768, value_dtype="bfloat16", max_probe_rounds=2,
        optimizer=JOptimizerConfig(kind="rowwise_adagrad", learning_rate=0.05)))
    shards, _ = jckpt.restore_shards(jspec, path, 1)
    restored = jckpt.export_shard_arrays(jspec, shards[0])
    saved = {k: np.concatenate([p[k] for p in tckpt.iter_rows(path)])
             for k in ("ids", "values", "freq", "last", "accum")}
    assert len(saved["ids"]) == got["rows"]
    a, b = np.argsort(saved["ids"]), np.argsort(restored["ids"])
    for k in saved:
        x, y = saved[k][a], np.asarray(restored[k])[b]
        if x.dtype == np.float32:
            x, y = x.view(np.int32), y.astype(np.float32).view(np.int32)
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert jnp.sum(shards[0].cnt) == got["rows"]


def test_ckpt_full_resumes_an_interrupted_save(tmp_path, monkeypatch):
    """A save cut after its first part file: the run fails, and the same
    run again skips that part (no fetch from the device) and writes the
    rest, with the sample still bit-exact."""
    set_env(monkeypatch, CKPT)
    path = str(tmp_path / "ck")
    fetch = tckpt._fetch_chunk
    calls = []

    def cut_after_one(shard, slots):
        calls.append(len(slots))
        if len(calls) > 1:
            raise KeyboardInterrupt("cut")
        return fetch(shard, slots)

    monkeypatch.setattr(tckpt, "_fetch_chunk", cut_after_one)
    with pytest.raises(KeyboardInterrupt):
        ckpt_full.run(device="cpu", ckpt_dir=path)
    assert not os.path.exists(os.path.join(path, "manifest.json"))
    calls.clear()
    monkeypatch.setattr(tckpt, "_fetch_chunk", lambda shard, slots: (calls.append(len(slots)),
                                                                     fetch(shard, slots))[1])
    got = ckpt_full.run(device="cpu", ckpt_dir=path)
    parts = -(-got["rows"] // 8192)
    assert parts == 4 and len(calls) == parts - 1  # part 0 was not fetched again
    assert got["sample_bit_exact"] is True
    assert tckpt.read_manifest(path)["counts"] == [got["rows"]]


@pytest.mark.parametrize("harness", ["headline", "phases", "stages", "evict", "ckpt_full"])
def test_row_merge_add_never_sees_a_row_twice(harness, unique_rows_only, tmp_path, monkeypatch,
                                              capsys):
    knobs = {"headline": {**HEADLINE, "MEEPO_BENCH_ZIPF": "0"}, "phases": PHASES,
             "stages": STAGES, "evict": EVICT,
             "ckpt_full": {**CKPT, "MEEPO_CKPT_DIR": str(tmp_path / "ck")}}[harness]
    set_env(monkeypatch, knobs)
    {"headline": headline, "phases": phases, "stages": stages, "evict": evict,
     "ckpt_full": ckpt_full}[harness].run(device="cpu")
    assert unique_rows_only and sum(unique_rows_only) > 0


def test_static_arm_adds_repeated_slots_once_each():
    """The all-rows static arm sums a slot drawn k times and adds the sum
    once: the same plane as `index_add_` of every draw, within the f32
    summation-order bound."""
    g = torch.Generator().manual_seed(0)
    values = torch.randn(64, 8, generator=g)
    slot = torch.randint(0, 16, (200,), generator=g, dtype=torch.int32)
    want = values.clone()
    rows = want[slot.long()].clone()
    upd = -0.05 * (rows * 1e-3 + 1e-4)
    want.index_add_(0, slot.long(), upd)
    # two f32 summation orders of a row's n terms differ by at most
    # n * eps * (the sum of their magnitudes)
    n = torch.zeros(64).index_add_(0, slot.long(), torch.ones(200))
    mag = values.abs().index_add_(0, slot.long(), upd.abs())
    bound = (n + 1)[:, None] * 2.0**-24 * mag
    got = values.clone()
    s = headline.static_cycle(got, slot, *headline.unique_batch(slot.numpy(), 200, "cpu"), 1e-4)
    assert torch.allclose(s, rows.sum())
    assert bool(((got - want).abs() <= bound).all())
    assert torch.equal(got[16:], values[16:])  # rows never drawn stay as they were


def _chip_smoke():
    path = os.path.join(REPO, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_holds_every_harness_kernel_call(monkeypatch):
    """`chip_smoke.held_kernels` holds each kernel call of a harness against
    the plain version on the same inputs, at each set of planes and size
    class: the headline reaches every kernel through it, the wrappers are
    put back after, and a kernel that disagrees or a repeated row of an
    in-place call fails."""
    smoke = _chip_smoke()
    held = []
    with smoke.held_kernels(held):
        headline.run(device="cpu", cap=1 << 12, batch=256, steps=2)
    assert {k for k, *_ in held} == {"row_gather", "row_scatter_set", "row_scatter_add",
                                     "row_merge_add", "segment_sum", "bucket_probe"}
    assert all(err == 0.0 for *_, err in held)
    assert table_ops.row_merge_add is kernels.row_merge_add
    assert table_ops.bucket_probe is kernels.bucket_probe
    plane, rows = torch.zeros(8, 4), torch.ones(2, 4)
    with pytest.raises(AssertionError, match="repeated rows"), smoke.held_kernels([]):
        table_ops.scatter_add_values(plane, torch.tensor([3, 3]), rows, torch.tensor([True, True]))
    # a kernel that adds its updates twice, seen from its plain version
    monkeypatch.setattr(smoke, "row_merge_add_plain",
                        lambda plane, vrow, upd: kernels.row_merge_add_plain(plane, vrow, upd / 2))
    with pytest.raises(AssertionError, match="disagrees"), smoke.held_kernels([]):
        table_ops.scatter_add_values(plane, torch.tensor([3, 5]), rows, torch.tensor([True, True]))


def test_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (headline, phases, stages, evict, ckpt_full):
        with pytest.raises(RuntimeError, match="no CUDA device is visible"):
            mod.run(device="cuda")


def test_headline_init_watchdog_exits_3(tmp_path):
    """A device that does not come up within MEEPO_BENCH_INIT_TIMEOUT: the
    reference's JSON line with an error, exit code 3, and no result (here
    the device's first allocation is held for 60 s)."""
    code = ("import sys, time, torch\n"
            "from meepoembedding_tpu_torch.bench import headline\n"
            "zeros = torch.zeros\n"
            "torch.zeros = lambda *a, **k: (time.sleep(60), zeros(*a, **k))[1]\n"
            "sys.argv = ['headline', '--device', 'cpu']\n"
            "headline.main()\n")
    env = dict(os.environ, PYTHONPATH=REPO, MEEPO_BENCH_INIT_TIMEOUT="1", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=env, cwd=str(tmp_path))
    assert out.returncode == 3, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metric"] == "lookup_update_ids_per_sec_per_chip" and line["value"] == 0.0
    assert "device init timed out after 1s" in line["error"]
