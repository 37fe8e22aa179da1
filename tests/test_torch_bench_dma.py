"""The port's K6 and K7 (`kernels.row_block_copy`) and its DMA probe
(`bench.dma`) against the TPU kernels of the root `bench_dma.py`.

`make_gather` and `make_scatter` are closures inside `bench_dma.main()`,
so the module fixture runs `main()` at a small size (a [4096, 128] plane,
256 descriptors, one index set, one repeat) with
`jax.experimental.pallas.pallas_call` replaced by a recorder. The
recorder keeps each real call as `main()` built it (interpret mode on the
CPU) and hands `main()` zeros for a gather and the aliased plane for a
scatter, so `main()` itself runs in about a second. The kept calls are the
sweep's 24 gathers and 6 scatters in the sweep's order, then the shipped
`row_gather`. Each test runs kept calls on seeded numpy inputs and holds
the port's plain versions and its CPU wrappers against them bit for bit:
the gather at R in (1, 2, 4, 32) with bases at and beyond the clip edge
(and below 0), the scatter at R in (1, 4, 16) on disjoint blocks of random
rows. The port's wrappers run at the ring the reference's W asks for
where it fits, else at `max_ring(R)`, as `bench.dma` does.
"""

import contextlib
import importlib.util
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from meepoembedding_tpu_torch.bench import dma
from meepoembedding_tpu_torch.kernels import (
    row_block_gather,
    row_block_gather_plain,
    row_block_scatter,
    row_block_scatter_plain,
)
from meepoembedding_tpu_torch.kernels import row_block_copy as rbc

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NROW, NDESC = 4096, 256
ENV = {"MEEPO_DMA_ROWS": str(NROW), "MEEPO_DMA_DESC": str(NDESC), "MEEPO_DMA_ITERS": "1",
       "MEEPO_DMA_REPEAT": "1"}
SWEEP = ([f"gather_R{R}_W{W}" for R in dma.GATHER_R for W in dma.GATHER_W]
         + [f"scatter_R{R}_W{W}" for R in dma.SCATTER_R for W in dma.SCATTER_W])


@pytest.fixture(scope="module")
def reference():
    """({sweep key: the real pallas call}, the reference's JSON line)."""
    spec = importlib.util.spec_from_file_location("_ref_bench_dma",
                                                  os.path.join(REPO, "bench_dma.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    real, kept = pl.pallas_call, []

    def recorder(kernel, **kw):
        kept.append((kw, real(kernel, **kw)))
        out = kw["out_shape"]
        if kw.get("input_output_aliases"):
            return lambda idx, upd, plane: plane
        return lambda idx, plane: jnp.zeros(out.shape, out.dtype)

    with pytest.MonkeyPatch.context() as mp:
        for k in [k for k in os.environ if k.startswith("MEEPO_")]:
            mp.delenv(k)
        for k, v in ENV.items():
            mp.setenv(k, v)
        mp.setattr(pl, "pallas_call", recorder)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            mod.main()
    assert len(kept) == len(SWEEP) + 1  # the sweep, then the shipped row_gather
    aliased = [bool(kw.get("input_output_aliases")) for kw, _ in kept]
    assert aliased == [k.startswith("scatter") for k in SWEEP] + [False]
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    return dict(zip(SWEEP, (call for _, call in kept))), line


def _port_w(R: int, W: int) -> int:
    return min(W, rbc.max_ring(R))


@pytest.mark.parametrize("R", [1, 2, 4, 32])
def test_gather_matches_bench_dma_kernel(reference, R):
    calls, _ = reference
    rng = np.random.default_rng(R)
    plane = rng.normal(size=(NROW, 128)).astype(np.float32)
    base = rng.integers(0, NROW - R, size=NDESC).astype(np.int32)
    # the clip edge: below 0, at nrow - R, and each of the R - 1 rows above it
    edge = np.array([-(2**31), -1, 0, NROW - R, NROW - 1, NROW, NROW + 7, 2**31 - 1]
                    + list(range(NROW - R, NROW)), np.int32)
    base[:len(edge)] = edge
    want = np.asarray(calls[f"gather_R{R}_W8"](jnp.asarray(base), jnp.asarray(plane)))
    assert want.shape == (NDESC * R, 128)
    p, b = torch.from_numpy(plane), torch.from_numpy(base)
    assert np.array_equal(row_block_gather_plain(p, b, R).numpy().view(np.int32),
                          want.view(np.int32))
    before = row_block_gather.launches
    for W in dma.GATHER_W:
        got = row_block_gather(p, b, R, _port_w(R, W))
        assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32)), W
    assert row_block_gather.launches == before  # the CPU takes the plain version


@pytest.mark.parametrize("R", [1, 4, 16])
def test_scatter_matches_bench_dma_kernel(reference, R):
    calls, _ = reference
    rng = np.random.default_rng(100 + R)
    plane = rng.normal(size=(NROW, 128)).astype(np.float32)
    # disjoint blocks: distinct multiples of 16 (the last one at nrow - 16)
    base = (rng.permutation(NROW // 16)[:NDESC] * 16).astype(np.int32)
    upd = rng.normal(size=(NDESC * R, 128)).astype(np.float32)
    want = np.asarray(calls[f"scatter_R{R}_W32"](jnp.asarray(base), jnp.asarray(upd),
                                                 jnp.asarray(plane)))
    b, u = torch.from_numpy(base), torch.from_numpy(upd)
    got = row_block_scatter_plain(torch.from_numpy(plane.copy()), b, u, R)
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    for W in dma.SCATTER_W:
        p = torch.from_numpy(plane.copy())
        assert row_block_scatter(p, b, u, R, _port_w(R, W)) is p
        assert np.array_equal(p.numpy().view(np.int32), want.view(np.int32)), W
    assert not np.array_equal(want, plane)


def test_run_keys_match_bench_dma(reference, monkeypatch, capsys):
    _, want = reference
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    capsys.readouterr()
    got = dma.run(device="cpu")
    err = capsys.readouterr().err.splitlines()
    assert err[0] == "cpu" and err[1].startswith("device: cpu, plane [4096,128]")
    rename = {"xla_take_ns_per_row": "library_take_ns_per_row", "xla_take_R1": "library_take_R1"}
    assert list(got)[:len(want)] == [rename.get(k, k) for k in want]
    assert list(got)[len(want):] == ["w_effective", "blocks_per_sm", "copies_in_flight",
                                     "row_gather_shipped"]
    assert list(got["sweep"]) == [rename.get(k, k) for k in want["sweep"]]
    assert got["metric"] == want["metric"] and got["unit"] == want["unit"]
    assert got["value"] == min(v for k, v in got["sweep"].items() if k.startswith("gather_R1_"))
    assert got["row_gather_shipped"] == got["sweep"]["row_gather_shipped"]
    # the 14 points whose ring does not fit a block run at the largest W that does
    rw = {k: tuple(int(x) for x in k.split("_R")[1].split("_W")) for k in SWEEP}
    assert got["w_effective"] == {k: rbc.max_ring(R) for k, (R, W) in rw.items()
                                  if W > rbc.max_ring(R)}
    assert len(got["w_effective"]) == 14
    assert got["blocks_per_sm"] is None and got["copies_in_flight"] is None  # no card
    assert all(v > 0 for v in got["sweep"].values())


def test_ring_limits():
    # 232,448 bytes a block: R * 512 + 8 bytes a slot beside 1 KB of bases
    assert [rbc.max_ring(R) for R in (1, 2, 4, 8, 16, 32)] == [256, 224, 112, 56, 28, 14]
    for R in (1, 2, 4, 8, 16, 32):
        assert rbc.smem_bytes(R, rbc.max_ring(R)) <= rbc.MAX_SMEM
        assert R == 1 or rbc.smem_bytes(R, rbc.max_ring(R) + 1) > rbc.MAX_SMEM
    assert rbc.smem_bytes(1, 1000) == rbc.smem_bytes(1, 256)  # min(W, 256) slots
    assert rbc.max_ring(452) == 0


def test_wrappers_refuse():
    plane = torch.zeros((64, 128))
    base = torch.zeros((4,), dtype=torch.int32)
    upd = torch.zeros((4 * 2, 128))
    cases = [
        (lambda: row_block_gather(plane, base, 32, 32), "shared memory"),
        (lambda: row_block_scatter(plane, base, torch.zeros((4 * 32, 128)), 32, 32),
         "shared memory"),
        (lambda: row_block_gather(plane, base, 65, 8), "R = 65"),
        (lambda: row_block_gather(plane, base, 0, 8), "R = 0"),
        (lambda: row_block_gather(plane, base, 2, 0), "W = 0"),
        (lambda: row_block_gather(plane.double(), base, 2, 8), "float32"),
        (lambda: row_block_gather(torch.zeros((64, 64)), base, 2, 8), "float32"),
        (lambda: row_block_gather(torch.zeros((64, 256))[:, :128], base, 2, 8), "contiguous"),
        (lambda: row_block_gather(torch.zeros(64 * 128 + 1)[1:].view(64, 128), base, 2, 8),
         "aligned"),
        (lambda: row_block_gather(plane, base.long(), 2, 8), "int32"),
        (lambda: row_block_gather(plane.to("meta"), base, 2, 8), "one device"),
        (lambda: row_block_scatter(plane, base, upd.to("meta"), 2, 8), "one device"),
        (lambda: row_block_scatter(plane, base, upd[:7], 2, 8), r"\[8, 128\]"),
        (lambda: row_block_gather(plane.to("meta"), base.to("meta"), 2, 8), "meta"),
    ]
    for call, match in cases:
        with pytest.raises(ValueError, match=match):
            call()
