"""Readings that taking a configuration by what its own files declare must
leave as they were for the two one-hot DLRM configurations: the tower's
leaves (against the former DLRM-only drawing, kept here), the FLOPs an
example (the integers the traced runs divided by), the port's model
settings (against the former seven-key construction), and the one-hot
feeds (digests of the arrays the former generator gave on two seeds)."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

import _perfbench_tiny
from harness import program, seeds, spec, traffic, weights, work
from meepoembedding_tpu_torch.config import ModelConfig

CONFIGS = {"dlrm-kaggle": "dlrm-kaggle.train", "dlrm-mlperf-tb": "dlrm-mlperf-tb.train"}


def _cfg(name):
    return spec.load_cell(CONFIGS[name], _perfbench_tiny.ROOT).config


def _old_layer_shapes(model):
    shapes, d = [], model["num_dense_features"]
    for h in model["bottom_mlp"]:
        shapes.append((d, h))
        d = h
    f = model["num_sparse_features"] + 1
    d = model["embedding_dim"] + f * (f - 1) // 2
    for h in model["top_mlp"]:
        shapes.append((d, h))
        d = h
    return shapes


def _old_tower_leaves(model, seed, device):
    shapes = _old_layer_shapes(model)
    total = sum(i * o + o for i, o in shapes)
    g = seeds.torch_gen(seed, "tower", device)
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    leaves, at = [], 0
    for i, o in shapes:
        w = flat[at:at + i * o].view(i, o) * (2.0 / (i + o)) ** 0.5
        at += i * o
        b = flat[at:at + o] * (1.0 / o) ** 0.5
        at += o
        leaves += [w, b]
    return leaves


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tower_leaves_are_bit_identical(name):
    cfg = _cfg(name)
    for seed in (3, 2**31 + 7):
        new = weights.tower_leaves(cfg, seed, "cpu")
        old = _old_tower_leaves(cfg["model"], seed, "cpu")
        assert len(new) == len(old)
        for a, b in zip(new, old):
            assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("name,flops", [("dlrm-kaggle", 2_916_192),
                                        ("dlrm-mlperf-tb", 14_750_976)])
def test_train_flops_per_example_are_the_old_integers(name, flops):
    assert work.train_flops_per_example(_cfg(name)) == flops


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_model_config_matches_the_old_construction(name):
    m = _cfg(name)["model"]
    old = ModelConfig(kind=m["kind"], num_dense_features=m["num_dense_features"],
                      num_sparse_features=m["num_sparse_features"],
                      embedding_dim=m["embedding_dim"], bottom_mlp=tuple(m["bottom_mlp"]),
                      top_mlp=tuple(m["top_mlp"]), dtype=m["dtype"])
    assert program.model_config(_cfg(name)) == old


def test_model_config_passes_every_field_and_only_fields():
    cfg = {"model": {"kind": "dcn", "num_dense_features": 2, "num_sparse_features": 3,
                     "embedding_dim": 8, "top_mlp": [4, 1], "num_cross_layers": 5,
                     "combiner": "sqrtn", "interaction": "dcn", "top_mlp_input": 9}}
    mc = program.model_config(cfg)
    assert (mc.kind, mc.num_cross_layers, mc.combiner, mc.top_mlp) == ("dcn", 5, "sqrtn", (4, 1))
    assert mc.bottom_mlp == ModelConfig().bottom_mlp  # absent: the port's default


# sha256 of the arrays below as the generator gave them before configurations
# could declare bags (the parent of the change that added them)
FEED_DIGESTS = {
    ("dlrm-kaggle.train", 5): "0ca96e26f274774d93bf06d6041de09dfb1923edf3487ecdc00a2b080080681e",
    ("dlrm-kaggle.train", 2**31 + 11):
        "603982dde2acc27823f47b73867a8d78d9d04899262173da9a6d238bf2f6baf5",
    ("dlrm-mlperf-tb.train", 5):
        "014c9904f59504c5d147e103e47855f9449b073b20d57dffeae9a50255e64720",
    ("dlrm-mlperf-tb.train", 2**31 + 11):
        "4325c3b256d73600d7019189680d0e32d3a61fd551485ba522a7673c13845560",
    ("dlrm-kaggle.serve", 5): "55a2b84a20e36fcdbfa33a6f2961c93356150042183a81ea7010a1c027b02e92",
    ("dlrm-kaggle.serve", 2**31 + 11):
        "ea09f6142a29815980af0e185587d921abfbd938f44a1f5965d24ca6cf519bde",
    ("dlrm-mlperf-tb.serve", 5):
        "7de898d3ffea546482adfb46d93048ea4b85e81ee4be2d0d395fcd788590f457",
    ("dlrm-mlperf-tb.serve", 2**31 + 11):
        "f6c074275a69a25e3d6f31cede9d4c3111fca3981e84584147fdaeb9ee9501b7",
}


def _feed_digest(workload, seed):
    cell = spec.load_cell(workload, _perfbench_tiny.ROOT)
    cfg, h = cell.config, hashlib.sha256()

    def add(a):
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    nd = cfg["model"]["num_dense_features"]
    if cell.loop == "closed":
        mix = {**cell.mix, "batch": 256, "pool_batches": 2}
        feed = traffic.TrainFeed(cfg["cardinalities"], mix, nd, seed)
        for _ in range(3):
            b = feed.next()
            for k in sorted(b):
                add(b[k])
        add(np.asarray([feed.ids_per_batch, feed.unique_per_step(0), feed.fresh_per_step(1)]))
    else:
        mix = {**cell.mix, "rate_rps": 300.0, "pool_candidates": 4096}
        s = traffic.ServeSchedule(cfg["cardinalities"], mix, nd, 5.0, seed)
        for a in (s.n, s.due, s.lo, s.ids, s.dense):
            add(a)
        for i in (0, 7):
            for a in s.inputs(i):
                add(a)
    return h.hexdigest()


@pytest.mark.parametrize("workload,seed", sorted(FEED_DIGESTS))
def test_one_hot_feeds_are_byte_identical(workload, seed):
    assert _feed_digest(workload, seed) == FEED_DIGESTS[(workload, seed)]
