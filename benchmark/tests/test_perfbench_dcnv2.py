"""MLPerf DLRM-DCNv2's configuration and its scoring cell: the widths and
the work its reference module declares, a tiny CPU rehearsal of the cell
coming out correct, and the faults a request can have (a bag element
dropped, the mean pooled in place of the sum, the cross net's V W product
left out) coming out not correct; the reference loads nothing of the
program, pools in a fixed order and trains in float64. The training cell is
held out of BENCHMARK.json (PERF.md section 4: no limit of the harness's
three-step numbers fails the TF32 control on every seed); `_train_cell`
builds its pieces for the checks that need no limits."""

from __future__ import annotations

import dataclasses
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

import _perfbench_tiny
from _perfbench_tiny import DCNV2_SIZES, tiny_cell
import run
from harness import check, program, spec, trace, weights, work

PAD = program.PAD_ID


def _config() -> dict:
    return spec.load_cell("dlrm-dcnv2.serve", _perfbench_tiny.ROOT).config


def _train_cell():
    """DLRM-DCNv2 under the Terabyte training cell's mix and metrics (B 8192,
    no first sightings: one GPU's share of MLPerf's 65,536), cut down, with
    no limits: the pieces of the held-out training cell."""
    return dataclasses.replace(tiny_cell("dlrm-mlperf-tb.train"), name="dlrm-dcnv2.train",
                               config=tiny_cell("dlrm-dcnv2.serve").config, limits={})


def test_the_configuration_is_the_published_one():
    cfg = _config()
    m = cfg["model"]
    assert cfg["multi_hot_sizes"] == DCNV2_SIZES and sum(DCNV2_SIZES) == 214
    assert (m["interaction"], m["num_cross_layers"], m["dcn_low_rank_dim"]) == ("dcn", 3, 512)
    assert (m["embedding_dim"], m["combiner"], m["top_mlp_input"]) == (128, "sum", 27 * 128)
    tb = spec.load_cell("dlrm-mlperf-tb.train", _perfbench_tiny.ROOT).config
    for k in ("cardinalities", "published_cardinalities", "table", "fill", "reduced", "cut"):
        assert cfg[k] == tb[k], k


def test_macs_and_leaves_at_the_published_widths():
    from meepoembedding_tpu_torch.models import build_model
    from meepoembedding_tpu_torch.weights import param_leaves

    cfg = _config()
    ref = spec.reference(cfg)
    assert ref.macs_per_example(cfg["model"]) == 16_030_464
    assert work.train_flops_per_example(cfg) == 6 * 16_030_464
    mlp = [(13, 512), (512,), (512, 256), (256,), (256, 128), (128,)]
    cross = [(3456, 512), (512, 3456), (3456,)] * 3
    top = [(3456, 1024), (1024,), (1024, 1024), (1024,), (1024, 512), (512,), (512, 256),
           (256,), (256, 1), (1,)]
    specs = ref.leaf_specs(cfg["model"])
    assert [s for s, _ in specs] == mlp + cross + top
    assert specs[6][1] == specs[7][1] == math.sqrt(2.0 / (3456 + 512)) and specs[8][1] == 0.0
    net = build_model(program.model_config(cfg))
    assert [tuple(p.shape[::-1]) if t else tuple(p.shape) for p, t in param_leaves(net)] == [
        s for s, _ in specs]


def test_the_scoring_cell_loads_and_the_training_cell_is_held_out():
    cell = tiny_cell("dlrm-dcnv2.serve")
    assert spec.reference(cell.config).__name__ == "reference.dlrm_dcnv2"
    assert {m.name for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) == 2
    assert cell.mix["rate_rps"] == 4000 and "serve.device_ms" in {m.name for m in cell.per_layer}
    for m in cell.per_layer:
        assert callable(cell.reader(m.name))
    with pytest.raises(KeyError):
        spec.load_cell("dlrm-dcnv2.train", _perfbench_tiny.ROOT)
    assert "tower_mfu" in {m.name for m in tiny_cell("dlrm-mlperf-tb.train").per_layer}


def test_tower_mfu_reads_the_tower_layer():
    read = tiny_cell("dlrm-mlperf-tb.train").reader("tower_mfu")
    tl = trace.Timeline((0.0, 1e6), 5e5, {"tower": 2e5, "table": 3e5}, [], [], 10)
    flops = work.train_flops_per_example(_config()) * 8192
    r = trace.Reading(tl, 10, "NVIDIA H100 80GB HBM3", flops_per_unit=flops)
    assert read(r) == pytest.approx(100.0 * flops / 0.02 / 67e12)
    assert read(trace.Reading(tl, 10, "NVIDIA H100 80GB HBM3")) is None
    assert read(trace.Reading(tl, 10, "another card", flops_per_unit=flops)) is None


def test_the_reference_loads_nothing_of_the_program():
    out = subprocess.run([sys.executable, "-c", "import reference.dlrm_dcnv2, sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, check=True, cwd=_perfbench_tiny.BENCH)
    top = set(out.stdout.split())
    assert "torch" in top
    assert not top & {"meepoembedding_tpu_torch", *run.FORBIDDEN}


def _drop_an_element(ids, lengths):
    """The last id of the first example's largest bag left out."""
    ids, lengths = np.array(ids, copy=True), np.array(lengths, copy=True)
    f = DCNV2_SIZES.index(max(DCNV2_SIZES))
    lengths[0, f] -= 1
    ids[0, f, lengths[0, f]] = PAD
    return ids, lengths


def _element_dropped(mp):
    from meepoembedding_tpu_torch.serving import ScoringService

    score = ScoringService.score

    def score_dropped(self, dense, ids, lengths=None):
        return score(self, dense, *_drop_an_element(ids, lengths))
    mp.setattr(ScoringService, "score", score_dropped)


def _mean_pooling(mp):
    from meepoembedding_tpu_torch.ops import pooling

    pool = pooling.pool_bags
    mp.setattr(pooling, "pool_bags", lambda emb, valid, combiner: pool(emb, valid, "mean"))


def _cross_product_lost(mp):
    """x0 * b + x: V and W stay in the graph (zero gradients), their
    product out of the layer."""
    from meepoembedding_tpu_torch.models import dlrm

    mp.setattr(dlrm, "cross_layer",
               lambda x0, x, v, w: torch.addcmul(x, x0, w.bias.expand_as(x)) + 0.0 * w(v(x)))


FAULTS = {"none": None, "element_dropped": _element_dropped, "mean_pooling": _mean_pooling,
          "cross_product_lost": _cross_product_lost}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_rehearsal_and_faults(fault, monkeypatch):
    cell = tiny_cell("dlrm-dcnv2.serve")
    if FAULTS[fault]:
        FAULTS[fault](monkeypatch)
    res = run.run_serve(cell, 2**31 + 977, 0.3, False, torch.device("cpu"))
    assert res["attempted"] > 0 and res["failed"] == 0
    ok = check.verdict(res["numbers"], cell.limits, cell.not_compared)
    assert ok == (fault == "none"), res["numbers"]


def test_the_window_counts_valid_ids():
    from harness import train_cell

    cell = _train_cell()
    tc = train_cell.TrainCell(cell, 2**31 + 3, "cpu")
    assert type(tc.trainer.model).__name__ == "DLRM" and tc.trainer.model_cfg.interaction == "dcn"
    w = tc.window(0.05)
    assert w["ids"] == w["steps"] * cell.mix["batch"] * 214
    leaves = weights.tower_leaves(cell.config, 2**31 + 3, "cpu")
    assert not leaves[8].any() and leaves[6].std() > 0


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_the_reference_pools_in_a_fixed_order(combiner):
    from reference import dlrm, dlrm_dcnv2

    g = torch.Generator().manual_seed(5)
    lengths = torch.randint(0, 9, (16, 5), generator=g, dtype=torch.int32)
    rows = torch.randn((int(lengths.sum()), 8), generator=g, dtype=torch.float64)
    got = dlrm_dcnv2.pool(rows, lengths, combiner)
    assert torch.equal(got, dlrm_dcnv2.pool(rows, lengths, combiner))
    torch.testing.assert_close(got, dlrm.pool(rows, lengths, combiner), rtol=1e-12, atol=1e-12)
    assert not got[lengths == 0].any()


def test_the_reference_trains_in_float64_and_the_control_in_float32():
    from harness import train_cell

    cell = _train_cell()
    tc = train_cell.TrainCell(cell, 2**31 + 5, "cpu")
    batches = [tc.feed.next() for _ in range(2)]
    ref = spec.reference(cell.config)
    dt = {}
    for kind in ("float32", "tf32"):
        leaves = weights.tower_leaves(cell.config, 2**31 + 5, "cpu")
        out = ref.train(cell.config["model"], cell.config["table"],
                        cell.config["dense_optimizer"], leaves,
                        [{**b, "ids": train_cell.valid_ids(b["ids"], b["lengths"])}
                         for b in batches],
                        train_cell.start_rows(cell.config, 2**31 + 5, "cpu"), "cpu", kind=kind)
        dt[kind] = {x.dtype for x in out["grad1"] + [out["grad1_table"], out["change_table"]]}
        assert torch.equal(leaves[0], weights.tower_leaves(cell.config, 2**31 + 5, "cpu")[0])
    assert dt == {"float32": {torch.float64}, "tf32": {torch.float32}}
