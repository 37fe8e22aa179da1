"""The port's path harnesses (`meepoembedding_tpu_torch/bench/`: serving,
retrieval, sharded_overhead, scaling) against the reference's root
scripts, whose `main()` runs in-process under JAX on the CPU with the
same `MEEPO_*` values as the port's `run(device="cpu")`.

Held: the JSON lines' keys and modes or phases, in the reference's order,
and what follows from the knobs alone (rows, table bytes, corpus, k,
world sizes); at a world of one the sharded trainer's fast path, dense
exchange and ragged exchange end on the single-device step's loss
(rtol 1e-5; they train the same rows on the same batches) with no route
drops, and the sharded group on the group's; scaling's gloo worlds of 1
and 2 give a rate and an efficiency each. Times are not compared: a CPU
run measures the CPU. The reference's sharded serving spans the 8 virtual
devices of this process (`tests/conftest.py`), the port's a world of one:
the mode's name carries S.

`test_row_merge_add_never_sees_a_row_twice` runs each harness (scaling's
rank in this process, at a world of one) through a wrapper of
`kernels.row_merge_add` that fails on a repeated enabled row.
"""

import json
import re

import pytest
import torch

from meepoembedding_tpu_torch.bench import retrieval, scaling, serving, sharded_overhead
from _torch_bench_parity import both, set_env, unique_rows_only  # noqa: F401

torch.set_num_threads(1)

SERVING = {"MEEPO_SRV_ROWS": "4096", "MEEPO_SRV_BATCH": "64", "MEEPO_SRV_STEPS": "5"}
RETRIEVAL = {"MEEPO_RET_ITEMS": "20000", "MEEPO_RET_STEPS": "3", "MEEPO_RET_BATCH": "64"}
OVERHEAD = {"MEEPO_OVERHEAD_CAP": "65536", "MEEPO_OVERHEAD_BATCH": "256",
            "MEEPO_OVERHEAD_FEATURES": "8", "MEEPO_OVERHEAD_STEPS": "3",
            "MEEPO_OVERHEAD_PREFILL": "3", "MEEPO_OVERHEAD_ARMS": "fast,exchange,ragged,group"}
SCALING = {"MEEPO_SCALE_DEVICES": "1,2", "MEEPO_SCALE_BATCH": "64", "MEEPO_SCALE_STEPS": "2"}
LOSS_TOL = 1e-5


def test_serving_matches_bench_serving(monkeypatch, capsys):
    want, _, got, terr = both("bench_serving", serving, SERVING, monkeypatch, capsys)
    assert terr.splitlines()[0] == "cpu"
    assert [w["mode"] for w in want][:2] == list(got)[:2] == ["f32", "int8"]
    assert want[2]["mode"].startswith("sharded_S") and list(got)[2] == "sharded_S1"
    for w, g in zip(want, got.values()):
        assert list(g) == list(w)
        assert g["scores_per_sec"] > 0 and 0 < g["p50_ms"] <= g["p99_ms"]
    f32, int8, sharded = got.values()
    assert f32["table_mb"] == want[0]["table_mb"] == sharded["table_mb"] == want[2]["table_mb"]
    # int8 bytes a row at dim 32: 44 in the reference (int32 ids), 56 in the
    # port (int64 ids and their copy in the side plane)
    assert want[1]["table_mb"] == round(4096 * 44 / 1e6, 1)
    assert int8["table_mb"] == round(4096 * 56 / 1e6, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_retrieval_matches_bench_retrieval(dtype, monkeypatch, capsys):
    want, _, got, _ = both("bench_retrieval", retrieval, {**RETRIEVAL, "MEEPO_RET_DTYPE": dtype},
                            monkeypatch, capsys)
    assert [w["phase"] for w in want] == list(got) == ["index_build", "topk"]
    for w, g in zip(want, got.values()):
        assert list(g) == list(w)
        for k in ("items", "corpus", "k", "dim", "index_dtype"):
            assert g.get(k) == w.get(k), k
    assert got["index_build"]["items_per_sec"] > 0 and got["topk"]["queries_per_sec"] > 0


def _losses(err: str) -> dict:
    """{arm's log label: its last loss} from the port's arm lines."""
    return {m.group(1).strip(): float(m.group(2))
            for m in re.finditer(r"^(.*?): .* ms/step .*loss=([-\d.e]+)$", err, re.M)}


def test_sharded_overhead_matches_bench_sharded_overhead(monkeypatch, capsys):
    want, _, got, terr = both("bench_sharded_overhead", sharded_overhead, OVERHEAD,
                               monkeypatch, capsys)
    assert list(got) == list(want[-1])
    assert got["devices"] == want[-1]["devices"] == 1
    assert got["ids_per_step"] == want[-1]["ids_per_step"] == 2048
    assert got["route_drops"] == 0
    losses = _losses(terr)
    fused = losses.pop("fused")
    group = losses.pop("group (4-table, single-device)")
    assert losses.pop("group (4-table, sharded S=1)") == pytest.approx(group, rel=LOSS_TOL)
    assert sorted(losses) == ["sharded (S=1 fast path)", "sharded (forced RAGGED exchange)",
                              "sharded (forced exchange)"]
    for arm, loss in losses.items():
        assert loss == pytest.approx(fused, rel=LOSS_TOL), arm
    assert re.findall(r"route_drops=(\d+)", terr) == ["0", "0", "0"]


def test_sharded_overhead_refuses_more_than_one_rank(monkeypatch):
    set_env(monkeypatch, {**OVERHEAD, "MEEPO_OVERHEAD_DEVICES": "2"})
    with pytest.raises(ValueError, match="one process a rank"):
        sharded_overhead.run(device="cpu")


def test_scaling_matches_bench_scaling(monkeypatch, capsys):
    want, _, got, terr = both("bench_scaling", scaling, SCALING, monkeypatch, capsys)
    assert list(got) == list(want[-1])
    assert got["platform"] == want[-1]["platform"] == "cpu"
    assert got["per_device_batch"] == want[-1]["per_device_batch"] == 64
    assert list(got["rates"]) == list(want[-1]["rates"]) == ["1", "2"]
    assert list(got["efficiency"]) == ["1", "2"] and got["efficiency"]["1"] == 1.0
    assert all(r > 0 for r in got["rates"].values())
    assert re.findall(r"^S=(\d): \d+ examples/s", terr, re.M) == ["1", "2"]
    # the plain versions on the CPU launch nothing: the counts are there, at 0
    for launches in re.findall(r"^S=\d: rank 0 launches (.*)$", terr, re.M):
        assert json.loads(launches) == {"row_gather": 0, "row_scatter_set": 0,
                                        "row_scatter_add": 0, "row_merge_add": 0}


def test_scaling_refuses_more_ranks_than_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(scaling, "start", lambda device: torch.device("cuda", 0))
    with pytest.raises(ValueError, match="needs as many cards"):
        scaling.run(device="cuda", devices="1,2")


@pytest.mark.parametrize("harness", ["serving", "retrieval", "sharded_overhead", "scaling"])
def test_row_merge_add_never_sees_a_row_twice(harness, unique_rows_only, tmp_path, monkeypatch):
    if harness == "scaling":  # one rank of a world of one, in this process
        scaling.rank_main(0, 1, str(tmp_path), "cpu", 64, 2)
        rank0 = json.loads((tmp_path / "rank0.json").read_text())
        assert rank0["seconds"] > 0
    else:
        set_env(monkeypatch, {"serving": SERVING, "retrieval": RETRIEVAL,
                           "sharded_overhead": OVERHEAD}[harness])
        {"serving": serving, "retrieval": retrieval,
         "sharded_overhead": sharded_overhead}[harness].run(device="cpu")
    if harness == "retrieval":  # towers and the index only: no table, no K1
        assert unique_rows_only == []
    else:
        assert sum(unique_rows_only) > 0


def test_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (serving, retrieval, sharded_overhead, scaling):
        with pytest.raises(RuntimeError, match="no CUDA device is visible"):
            mod.run(device="cuda")
