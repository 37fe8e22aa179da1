"""The port's dense row-sharded exchange and ShardedTrainer, as S = 2 and 4
gloo processes, against the JAX package on meshes of 2 and 4 virtual CPU
devices from the same numpy inputs (`tests/_torch_dist_parity.py` says
what is exact and what is held within a tolerance). Also the stacked-shard
converter of `weights.py`."""

import numpy as np
import pytest
import torch

from _torch_dist_parity import (
    assert_stacked_match,
    cat,
    check_trainer,
    exchange_case,
    port_stacked,
    run_ranks,
    trainer_case,
)
from meepoembedding_tpu.parallel import sharded_table as jst
from meepoembedding_tpu_torch.config import OptimizerConfig, TableConfig
from meepoembedding_tpu_torch.table.layout import TableSpec, alloc_shard
from meepoembedding_tpu_torch.weights import shard_from_stacked, stacked_from_shards

torch.set_num_threads(1)

@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every case of this file: the JAX references, then one gloo world of
    each size that runs the port's side of all of them."""
    tmp = tmp_path_factory.mktemp("sharded")
    out = {}
    for S in (2, 4):
        cases, refs = [], []
        for name, (case, ref) in [
            ("exchange", exchange_case(S, 256, 1.25, seed=S)),
            ("trainer", trainer_case(S, seed=10 + S)),
        ]:
            cases.append(case)
            refs.append((name, ref))
        if S == 2:
            extra = [
                # small a2a_factor: route drops, and the trainer's resize
                ("drops", exchange_case(S, 1024, 0.25, seed=5)),
                ("resize", trainer_case(S, seed=21, batch=512, factor=0.25, remove=False)),
                ("eval_drops", trainer_case(S, seed=22, steps=0, batch=512, factor=0.25,
                                             remove=False)),
                ("growth", trainer_case(S, seed=23, batch=128, remove=False, evaluate=False,
                                         table_extra={"grow_at_load": 0.5, "capacity": 2048})),
                # LFU/TTL eviction into each rank's spill tier, then promotion
                ("maintenance", trainer_case(S, seed=25, steps=6, remove=False,
                                             maintenance_every=2, table_extra={
                                                 "policy": {"evict_policy": "lfu_ttl",
                                                            "ttl_steps": 1, "lfu_min_freq": 2,
                                                            "max_evict_per_pass": 256,
                                                            "evict_scan_buckets": 16}})),
                # a bf16 table: its gradients ride the wire in bf16
                ("bf16", trainer_case(S, seed=24, remove=False, evaluate=False,
                                       table_extra={"value_dtype": "bfloat16"})),
            ]
            for name, (case, ref) in extra:
                cases.append(case)
                refs.append((name, ref))
            # the pipelined trainer on the trainer case's inputs
            pipelined = dict(cases[1], args=dict(cases[1]["args"],
                                                 run=dict(cases[1]["args"]["run"],
                                                          pipeline_depth=2)))
            cases.append(pipelined)
            refs.append(("pipelined", refs[1][1]))
        ranks = run_ranks(tmp, S, cases)
        out[S] = {name: (ref, r) for (name, ref), r in zip(refs, ranks)}
    return out


@pytest.mark.parametrize("S", [2, 4])
def test_exchange_lookup_train_and_probe(worlds, S):
    (steps, probe_rows, probe_drops, stacked), ranks = worlds[S]["exchange"]
    for s, ref in enumerate(steps):
        for k in ("owner", "pos", "ok"):
            np.testing.assert_array_equal(cat(ranks, f"{k}{s}"), ref[k], err_msg=f"{k} {s}")
        np.testing.assert_array_equal(cat(ranks, f"rows{s}"), ref["rows"], err_msg=f"rows {s}")
    np.testing.assert_array_equal(cat(ranks, "probe_rows"), probe_rows)
    assert probe_drops == 0 and not cat(ranks, "probe_drops").any()
    assert_stacked_match(stacked, port_stacked(ranks), exact=True)
    assert (port_stacked(ranks)["cnt"].sum(axis=1) > 0).all()  # keys on every shard


def test_exchange_route_drops_at_small_factor(worlds):
    (steps, probe_rows, probe_drops, stacked), ranks = worlds[2]["drops"]
    for s, ref in enumerate(steps):
        assert not ref["ok"].all()
        for k in ("owner", "pos", "ok"):
            np.testing.assert_array_equal(cat(ranks, f"{k}{s}"), ref[k])
        np.testing.assert_array_equal(cat(ranks, f"rows{s}"), ref["rows"])
    np.testing.assert_array_equal(cat(ranks, "probe_rows"), probe_rows)
    assert probe_drops > 0 and int(cat(ranks, "probe_drops").sum()) == probe_drops
    p = port_stacked(ranks)
    assert p["counters"][:, jst.ROUTE_DROPS].sum() > 0
    assert_stacked_match(stacked, p, exact=True)


@pytest.mark.parametrize("S", [2, 4])
def test_trainer_steps_eval_remove(worlds, S):
    ref, ranks = worlds[S]["trainer"]
    check_trainer(ref, ranks, f"S={S}")


def test_trainer_auto_resize_on_route_drops(worlds):
    ref, ranks = worlds[2]["resize"]
    assert ref["factors"][-1] > 0.25 and ref["trainer"].counters()["route_drops"] > 0
    check_trainer(ref, ranks, "resize")


def test_eval_reports_route_drops(worlds):
    ref, ranks = worlds[2]["eval_drops"]
    assert ref["eval"]["route_drops"] > 0
    check_trainer(ref, ranks, "eval drops")


def test_growth_in_lockstep(worlds):
    ref, ranks = worlds[2]["growth"]
    assert ref["trainer"].spec.capacity > 1024  # grew from 1024 slots a shard
    check_trainer(ref, ranks, "growth")


def test_pipelined_equals_synchronous(worlds):
    (_, sync), (_, piped) = worlds[2]["trainer"], worlds[2]["pipelined"]
    for a, b in zip(sync, piped):
        np.testing.assert_array_equal(b["losses"], a["losses"])
        assert np.isnan(b["returned"][:2]).all()
        np.testing.assert_array_equal(b["returned"][2:], a["losses"][:1])
        for k in a:
            if k.startswith(("key_", "values", "opt_", "param")):
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)


@pytest.mark.parametrize("dtype,opt", [("float32", "rowwise_adagrad"), ("bfloat16", "adam")])
def test_stacked_converter_round_trip(dtype, opt):
    """shard_from_stacked of stacked_from_shards gives the shards back bit
    for bit, in the reference's stacked layout ([S, ...] planes, values as
    128-lane rows)."""
    cfg = TableConfig(dim=16, capacity=1 << 13, value_dtype=dtype,
                      optimizer=OptimizerConfig(kind=opt))
    spec = TableSpec.from_config(cfg, num_shards=2)
    g = torch.Generator().manual_seed(0)
    shards = []
    for _ in range(2):
        sh = alloc_shard(spec, "cpu")
        for p in (sh.key_hi, sh.freq, sh.counters, *sh.opt_rowwise):
            p.copy_(torch.randint(-1000, 1000, p.shape, generator=g).to(p.dtype))
        for p in (sh.values, *sh.opt_fulldim):
            p.copy_(torch.randn(p.shape, generator=g).to(p.dtype))
        shards.append(sh)
    st = stacked_from_shards(shards)
    assert st["values"].shape == (2, spec.capacity * 16 // 128, 128)
    assert st["key_hi"].shape == (2, spec.num_buckets, 128)
    assert len(st["opt_fulldim"]) == cfg.optimizer.num_fulldim_slots()

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    for r, sh in enumerate(shards):
        back = shard_from_stacked(st, r)
        for f in ("key_hi", "key_lo", "cnt", "ovf", "freq", "last", "values", "counters", "cms",
                  "opt_rowwise", "opt_fulldim"):
            a, b = getattr(sh, f), getattr(back, f)
            for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
                assert x.dtype == y.dtype and torch.equal(bits(x), bits(y)), f


def test_bf16_wire(worlds):
    """A bf16 table's gradients cross in bf16 (GRAD_WIRE_BF16, on by
    default in both packages), quantized before the owner's f32 sum."""
    ref, ranks = worlds[2]["bf16"]
    assert jst.GRAD_WIRE_BF16
    check_trainer(ref, ranks, "bf16")


def test_maintenance_spill_and_promotion(worlds):
    """Eviction passes on every rank's shard into its own spill tier, then
    the spilled ids trained again are promoted back at maintenance, as the
    JAX package's trainer does over its one tier."""
    ref, ranks = worlds[2]["maintenance"]
    assert sum(ref["evicted"]) > 0 and ref["promoted"] > 0
    check_trainer(ref, ranks, "maintenance")
