"""The port's ragged exchange (`parallel/ragged.py`, torch's
`all_to_all_single` with split sizes) as S = 2 and 4 gloo processes,
against the JAX package's ragged exchange on meshes of 2 and 4 virtual
CPU devices (its emulated transport, element-exact to the ragged
collective), and against the port's own dense exchange; and the forced
exchange on a world of one (`FORCE_EXCHANGE`) against the JAX package's.
Tolerances: `tests/_torch_dist_parity.py`."""

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

torch.set_num_threads(1)

RAGGED = {"a2a_ragged": True}


def _dense_twin(case):
    """The same exchange case over the port's dense exchange."""
    return dict(case, args=dict(case["args"], ragged=False))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ragged")
    out = {}
    for S in (2, 4):
        named = [("exchange", exchange_case(S, 256, 1.25, seed=30 + S, ragged=True)),
                 ("trainer", trainer_case(S, seed=40 + S, extra_run=RAGGED))]
        if S == 2:
            # an undersized receiver: clamped tails, drops, the resize
            named += [("drops", exchange_case(S, 1024, 0.35, seed=50, ragged=True)),
                      ("resize", trainer_case(S, seed=51, batch=512, factor=0.35, remove=False,
                                              extra_run=RAGGED))]
        cases = [c for _, (c, _) in named]
        cases.append(_dense_twin(named[0][1][0]))
        ranks = run_ranks(tmp, S, cases)
        out[S] = {name: (ref, r) for (name, (_, ref)), r in zip(named, ranks)}
        out[S]["dense_twin"] = (None, ranks[-1])
    return out


def _check_exchange(ref, ranks):
    steps, probe_rows, probe_drops, stacked = ref
    for s, want in enumerate(steps):
        np.testing.assert_array_equal(cat(ranks, f"ok{s}"), want["ok"], err_msg=f"ok {s}")
        np.testing.assert_array_equal(cat(ranks, f"rows{s}"), want["rows"], err_msg=f"rows {s}")
    np.testing.assert_array_equal(cat(ranks, "probe_rows"), probe_rows)
    assert int(cat(ranks, "probe_drops").sum()) == probe_drops
    assert_stacked_match(stacked, port_stacked(ranks), exact=True)


@pytest.mark.parametrize("S", [2, 4])
def test_ragged_exchange_matches_jax(worlds, S):
    ref, ranks = worlds[S]["exchange"]
    _check_exchange(ref, ranks)
    assert ref[2] == 0 and not port_stacked(ranks)["counters"][:, jst.ROUTE_DROPS].any()


@pytest.mark.parametrize("S", [2, 4])
def test_ragged_equals_dense_exchange(worlds, S):
    """The owners dedup what they receive in id order, so the two
    transports give the same slots, rows and planes, bit for bit."""
    (_, ragged), (_, dense) = worlds[S]["exchange"], worlds[S]["dense_twin"]
    for a, b in zip(ragged, dense):
        for k in a:
            if k.startswith(("rows", "probe_rows", "key_", "values", "cnt", "freq", "last")):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_ragged_clamp_counts_drops(worlds):
    ref, ranks = worlds[2]["drops"]
    assert ref[2] > 0
    _check_exchange(ref, ranks)
    assert port_stacked(ranks)["counters"][:, jst.ROUTE_DROPS].sum() > 0


@pytest.mark.parametrize("S", [2, 4])
def test_ragged_trainer_steps_eval_remove(worlds, S):
    ref, ranks = worlds[S]["trainer"]
    check_trainer(ref, ranks, f"ragged S={S}")


def test_ragged_trainer_auto_resize(worlds):
    ref, ranks = worlds[2]["resize"]
    assert ref["factors"][-1] > 0.35 and ref["trainer"].counters()["route_drops"] > 0
    check_trainer(ref, ranks, "ragged resize")


@pytest.mark.parametrize("ragged", [False, True])
def test_forced_exchange_on_a_world_of_one(tmp_path, monkeypatch, ragged):
    """FORCE_EXCHANGE runs the route -> all-to-all -> owner dedup -> lookup
    -> way back path at S = 1, as on one card, in both packages."""
    monkeypatch.setattr(jst, "FORCE_EXCHANGE", True)
    case, ref = trainer_case(1, seed=60, extra_run={"a2a_ragged": ragged})
    (ranks,) = run_ranks(tmp_path, 1, [case], force_exchange=True)
    check_trainer(ref, ranks, f"forced S=1 ragged={ragged}")
