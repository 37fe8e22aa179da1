"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `gpu` and skips without a CUDA device (decided
inside the test, never at import). The file imports no JAX, so it also runs
on a machine that has only PyTorch; `tests/conftest.py` imports JAX, so run
it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import pytest
import torch

from meepoembedding_tpu_torch.kernels import (
    row_gather,
    row_gather_multi,
    row_gather_multi_plain,
    row_gather_plain,
    row_merge_add,
    row_merge_add_plain,
    row_scatter_add,
    row_scatter_add_plain,
    row_scatter_set,
    row_scatter_set_multi,
    row_scatter_set_multi_plain,
    row_scatter_set_plain,
    segment_size,
    segment_sum,
)

torch.set_num_threads(1)


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run only on the card")
    return torch.device("cuda")


def _random_plane(shape, dtype, g, dev):
    if dtype == torch.int32:
        return torch.randint(-(2**31), 2**31 - 1, shape, device=dev, dtype=dtype, generator=g)
    return torch.randn(shape, device=dev, generator=g).to(dtype)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [6, 32, 128, 256])
def test_row_gather_matches_plain(dtype, width):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(width)
    R, n = 1 << 16, 40_000
    plane = _random_plane((R, width), dtype, g, dev)
    idx = torch.randint(-100, R + 100, (n,), device=dev, dtype=torch.int32, generator=g)
    before = row_gather.launches
    got = row_gather(plane, idx)
    torch.cuda.synchronize()
    assert row_gather.launches == before + 1
    assert torch.equal(_bits(got), _bits(row_gather_plain(plane, idx)))


def _onehot_dup_elements(R, n, width, g, dev):
    """Flat [R * width] indices of rows repeated `copies` times with one
    distinct lane each (disjoint one-hot lanes, as the bucket-plane sets
    have them), plus dropped indices below 0 and at or beyond R * width."""
    copies = 8
    base = torch.randperm(R, device=dev, generator=g)[: n // copies].to(torch.int32)
    j = torch.arange(n // copies * copies, device=dev)
    span = width // copies
    lane = (j % copies) * span + torch.randint(0, span, j.shape, device=dev, generator=g)
    idx = (base[j // copies] * width + lane).to(torch.int32)
    idx[1::11] = R * width + 3
    idx[2::13] = -5
    return idx


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("elements", [True, False])
def test_row_scatter_set_matches_plain(dtype, elements):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(int(elements))
    R, n, W = 1 << 16, 20_000, 128
    kernel = _random_plane((R, W), dtype, g, dev)
    if elements:  # one-hot lanes of duplicate rows, on the flat view
        idx = _onehot_dup_elements(R, n, W, g, dev)
        kernel = kernel.view(-1, 1)
    else:  # whole rows: unique, some out of range
        idx = (torch.randperm(R + 64, device=dev, generator=g)[:n] - 32).to(torch.int32)
    upd = _random_plane((idx.shape[0], kernel.shape[1]), dtype, g, dev)
    plain = kernel.clone()
    before = row_scatter_set.launches
    row_scatter_set(kernel, idx, upd)
    torch.cuda.synchronize()
    assert row_scatter_set.launches == before + 1
    row_scatter_set_plain(plain, idx, upd)
    assert torch.equal(_bits(kernel), _bits(plain))


@pytest.mark.gpu
def test_wrappers_refuse_mixed_devices():
    dev = _cuda()
    plane = torch.zeros((8, 4), device=dev)
    with pytest.raises(ValueError):
        row_gather(plane, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        row_scatter_set(plane, torch.zeros(2, dtype=torch.int32), torch.zeros(2, 4))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("width", [1, 3, 32, 128])
def test_row_scatter_add_matches_plain(dtype, width):
    """Unique rows, some below 0 and some at or beyond R (dropped): bit-exact,
    int32 wrapping."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(width)
    R, n = 1 << 16, 20_000
    kernel = _random_plane((R, width), dtype, g, dev)
    idx = (torch.randperm(R + 64, device=dev, generator=g)[:n] - 32).to(torch.int32)
    upd = _random_plane((n, width), dtype, g, dev)
    plain = kernel.clone()
    before = row_scatter_add.launches
    row_scatter_add(kernel, idx, upd)
    torch.cuda.synchronize()
    assert row_scatter_add.launches == before + 1
    row_scatter_add_plain(plain, idx, upd)
    assert torch.equal(_bits(kernel), _bits(plain))


def _dup_rows(R, m, g, dev):
    """m row indices with heavy repeats (a few rows hundreds of times, as a
    Zipf head gives them) and dropped rows below 0 and at or beyond R."""
    hot = torch.randint(0, R, (8,), device=dev, generator=g)
    vrow = torch.randint(0, R, (m,), device=dev, generator=g)
    pick = torch.rand((m,), device=dev, generator=g)
    vrow = torch.where(pick < 0.3, hot[torch.randint(0, 8, (m,), device=dev, generator=g)], vrow)
    vrow[::97] = -1
    vrow[1::89] = R + 5
    return vrow.to(torch.int32)


def _order_bound(base, vrow, upd):
    """Per element, the most two f32 sums of the same terms in different
    orders can differ by: 2 * k * 2^-24 * (|old| + sum |upd|) for a row
    with k updates (recursive summation's error bound, for each order)."""
    absum = base.float().abs()
    row_merge_add_plain(absum, vrow, upd.abs())
    ok = (vrow >= 0) & (vrow < base.shape[0])
    k = torch.zeros(base.shape[0], device=base.device)
    k.index_add_(0, vrow[ok].long(), torch.ones_like(vrow[ok], dtype=torch.float32))
    return 2 * (k + 1)[:, None] * 2**-24 * absum


def assert_within_order_bound(got, want, bound):
    """f32: within `bound`; bf16: also one bf16 unit in the last place of
    the result (at most 2^-7 of it), since both round their f32 sums once."""
    if got.dtype == torch.bfloat16:
        bound = bound + want.float().abs() * 2**-7
    err = (got.float() - want.float()).abs()
    assert bool((err <= bound).all()), f"max excess {float((err - bound).max())}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [3, 8, 32, 40, 128, 256])
def test_row_merge_add_matches_plain(dtype, width):
    """Unique rows (the unique-row add, no sort), rows below 0 and at or
    beyond R dropped: bit-exact, one launch. Duplicate rows go to the
    segment sum, from zero into f32: the plain version adds them with
    atomics in no fixed order, so within the bound of two summation orders
    (`_order_bound`), and the kernels give the same bits on two calls."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(width)
    R, m = 1 << 14, 30_000
    base = _random_plane((R, width), dtype, g, dev)
    upd = torch.randn((m, width), device=dev, generator=g)

    uniq = (torch.randperm(R + 64, device=dev, generator=g)[:R // 2] - 32).to(torch.int32)
    kernel, plain = base.clone(), base.clone()
    before = row_merge_add.launches
    row_merge_add(kernel, uniq, upd[: uniq.shape[0]].contiguous())
    torch.cuda.synchronize()
    assert row_merge_add.launches == before + 1
    row_merge_add_plain(plain, uniq, upd[: uniq.shape[0]])
    assert torch.equal(_bits(kernel), _bits(plain))

    vrow = _dup_rows(R, m, g, dev)
    first = segment_sum(upd, vrow, R)
    again = segment_sum(upd, vrow, R)
    zero = torch.zeros((R, width), device=dev)
    plain = row_merge_add_plain(zero.clone(), vrow, upd)
    torch.cuda.synchronize()
    assert torch.equal(_bits(first), _bits(again))
    assert_within_order_bound(first, plain, _order_bound(zero, vrow, upd))


@pytest.mark.gpu
def test_segment_sum_backward_on_card():
    """GatherRows: forward row_gather by the inverse, backward the K1 segment
    sum; against a CPU run of the same function."""
    from meepoembedding_tpu_torch.ops.dedup import GatherRows

    dev = _cuda()
    g = torch.Generator().manual_seed(0)
    U, n, dim = 5000, 40_000, 32
    rows = torch.randn((U, dim), generator=g)
    inv = torch.randint(0, U, (n,), generator=g, dtype=torch.int32)
    w = torch.randn((n, dim), generator=g)
    grads = []
    for d in ("cpu", dev):
        r = rows.detach().to(d).requires_grad_(True)
        (GatherRows.apply(r, inv.to(d)) * w.to(d)).sum().backward()
        grads.append(r.grad.cpu())
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_add_wrappers_refuse_mixed_devices():
    dev = _cuda()
    plane = torch.zeros((8, 4), device=dev)
    with pytest.raises(ValueError):
        row_scatter_add(plane, torch.zeros(2, dtype=torch.int32), torch.zeros(2, 4))
    with pytest.raises(ValueError):
        row_merge_add(plane, torch.zeros(2, dtype=torch.int32), torch.zeros(2, 4))


@pytest.mark.gpu
def test_new_wrappers_refuse_mixed_devices():
    dev = _cuda()
    plane = torch.zeros((8, 4), device=dev)
    idx = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        row_merge_add(plane, idx.cpu(), torch.zeros(2, 4, device=dev))
    with pytest.raises(ValueError):
        segment_sum(torch.zeros(2, 4, device=dev), idx.cpu(), 8)
    with pytest.raises(ValueError):
        segment_sum(torch.zeros(2, 4, device=dev), idx, 8, torch.zeros(2, dtype=torch.int64),
                    idx)
    with pytest.raises(ValueError):
        row_scatter_set_multi([plane, plane.cpu()], idx, [1, 2])
    with pytest.raises(ValueError):
        row_scatter_set_multi([plane], idx, [torch.zeros(2, 4)])


def _runs(counts, g, dev):
    """Row ids in a random order, row r repeated counts[r] times."""
    rows = torch.repeat_interleave(torch.arange(len(counts), device=dev),
                                   torch.tensor(counts, device=dev))
    return rows[torch.randperm(rows.shape[0], device=dev, generator=g)].to(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("sorted_given", [True, False])
def test_segment_sum_short_runs_exact_long_runs_bounded(sorted_given):
    """Runs of 1 to S updates (S = segment_size()) give exactly the
    input-order sum (the plain version on the CPU); runs of S + 1 to 5,000
    stay within the summation-order bound; two calls give the same bits."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(3)
    S = segment_size()
    counts = [1 + (r * 7) % S for r in range(3000)]
    counts += [S + 1, 2 * S - 1, 2 * S, 3 * S + 5, 777, 5000]
    vrow = _runs(counts, g, dev)
    upd = torch.randn((vrow.shape[0], 32), device=dev, generator=g)
    U = len(counts) + 10  # rows no run reaches read zero
    sort = {}
    if sorted_given:
        sorted_rows, order = torch.sort(vrow, stable=True)
        sort = dict(order=order, sorted_rows=sorted_rows)
    before = row_merge_add.launches
    first = segment_sum(upd, vrow, U, **sort)
    again = segment_sum(upd, vrow, U, **sort)
    torch.cuda.synchronize()
    assert row_merge_add.launches == before + 4  # two kernels a call
    assert torch.equal(_bits(first), _bits(again))
    want = row_merge_add_plain(torch.zeros((U, 32)), vrow.cpu(), upd.cpu())
    short = torch.zeros(U, dtype=torch.bool)
    short[:len(counts)] = torch.tensor(counts) <= S
    short[len(counts):] = True
    got = first.cpu()
    assert torch.equal(_bits(got[short]), _bits(want[short]))
    assert_within_order_bound(got, want, _order_bound(torch.zeros((U, 32)), vrow.cpu(),
                                                      upd.cpu()))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 4, 8])
def test_row_scatter_set_multi_matches_plain(k):
    """K planes of one shape, int32 and f32, tensor and scalar values, on
    the flat view of [R, 128] planes: bit-exact, one launch."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(k)
    R, n = 1 << 12, 20_000
    planes = [_random_plane((R, 128), torch.int32 if p % 2 == 0 else torch.float32, g, dev)
              .view(-1, 1) for p in range(k)]
    idx = _onehot_dup_elements(R, n, 128, g, dev)
    scalars = [7, -0.25, 2**31 + 3, 1e30]
    values = [_random_plane((idx.shape[0], 1), p.dtype, g, dev) if j % 3 == 0
              else scalars[j % 4] for j, p in enumerate(planes)]
    want = [p.clone() for p in planes]
    before = row_scatter_set.launches
    row_scatter_set_multi(planes, idx, values)
    torch.cuda.synchronize()
    assert row_scatter_set.launches == before + 1
    row_scatter_set_multi_plain(want, idx, values)
    for got, exp in zip(planes, want):
        assert torch.equal(_bits(got), _bits(exp))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("width", [1, 32, 128, 256])
@pytest.mark.parametrize("esize", [4, 2])
def test_row_gather_multi_matches_plain(k, width, esize):
    """K planes of one shape that share an index (int32 and f32 mixed, or
    bf16), indices below 0 and at or beyond R, n not a multiple of 4; also
    with an index that is not 16-byte aligned. Bit-exact, one launch a call."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(100 * k + width + esize)
    R, n = 1 << 14, 40_003
    dtypes = (torch.int32, torch.float32) if esize == 4 else (torch.bfloat16,)
    planes = [_random_plane((R, width), dtypes[p % len(dtypes)], g, dev) for p in range(k)]
    idx = torch.randint(-100, R + 100, (n + 1,), device=dev, dtype=torch.int32, generator=g)
    before = row_gather.launches
    for i in (idx[:n], idx[1:]):
        got = row_gather_multi(planes, i)
        torch.cuda.synchronize()
        for a, b in zip(got, row_gather_multi_plain(planes, i)):
            assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    assert row_gather.launches == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("width", [1, 3, 32, 128])
def test_row_scatter_add_fetch_matches_plain(dtype, width):
    """The fetch-add: unique rows, some below 0 and some at or beyond R;
    the plane's bits and `old` (0 on dropped rows) equal the plain
    version's, int32 wrapping; n not a multiple of 4."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(7 * width)
    R, n = 1 << 16, 20_003
    kernel = _random_plane((R, width), dtype, g, dev)
    idx = (torch.randperm(R + 64, device=dev, generator=g)[:n] - 32).to(torch.int32)
    upd = _random_plane((n, width), dtype, g, dev)
    plain = kernel.clone()
    old = torch.full((n, width), 9, dtype=dtype, device=dev)
    want_old = torch.empty_like(old)
    before = row_scatter_add.launches
    row_scatter_add(kernel, idx, upd, old)
    torch.cuda.synchronize()
    assert row_scatter_add.launches == before + 1
    row_scatter_add_plain(plain, idx, upd, want_old)
    assert torch.equal(_bits(kernel), _bits(plain))
    assert torch.equal(_bits(old), _bits(want_old))
    dropped = (idx < 0) | (idx >= R)
    assert bool(dropped.any()) and not bool(old[dropped].any())


@pytest.mark.gpu
def test_gather_and_fetch_add_refuse_mixed_devices_and_rows():
    dev = _cuda()
    plane = torch.zeros((8, 4), device=dev)
    idx = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # planes on two devices
        row_gather_multi([plane, plane.cpu()], idx)
    with pytest.raises(ValueError):  # idx on the CPU
        row_gather_multi([plane, plane], idx.cpu())
    with pytest.raises(ValueError):  # mixed row bytes
        row_gather_multi([plane, torch.zeros((8, 8), device=dev)], idx)
    with pytest.raises(ValueError):  # old on the CPU
        row_scatter_add(plane, idx, torch.zeros((2, 4), device=dev), torch.zeros((2, 4)))


# --- the lifecycle's calls on the card against the same calls on CPU copies ---

def _lifecycle_pair(kind="rowwise_adagrad", value_dtype="float32", **policy):
    """A CPU table of 2^16 slots holding 40,000 rows with random freq, last
    and optimizer state, and its copy on the card."""
    import dataclasses

    from meepoembedding_tpu_torch.config import OptimizerConfig, PolicyConfig, TableConfig
    from meepoembedding_tpu_torch.table import hashing, table_ops
    from meepoembedding_tpu_torch.table.layout import TableSpec, alloc_shard

    dev = _cuda()
    cfg = TableConfig(dim=32, capacity=1 << 16, value_dtype=value_dtype,
                      optimizer=OptimizerConfig(kind=kind), policy=PolicyConfig(**policy))
    spec = TableSpec.from_config(cfg)
    cpu = alloc_shard(spec, "cpu")
    g = torch.Generator().manual_seed(7)
    n = 40_000
    ids = torch.randint(-(2**62), 2**62, (n,), generator=g)
    hi, lo = hashing.split_ids_t(ids)
    table_ops.insert_rows(
        spec, cpu, hi, lo, torch.randn((n, 32), generator=g), torch.ones(n, dtype=torch.bool),
        40, freq=torch.randint(1, 6, (n,), generator=g, dtype=torch.int32),
        last=torch.randint(0, 40, (n,), generator=g, dtype=torch.int32),
        accum=torch.rand((n,), generator=g),
        fulldim=[torch.randn((n, 32), generator=g) for _ in cpu.opt_fulldim] or None)

    def to(shard, d):
        return type(shard)(**{f.name: (tuple(t.to(d, copy=True) for t in v)
                                       if isinstance(v, tuple) else v.to(d, copy=True))
                              for f in dataclasses.fields(shard) for v in [getattr(shard, f.name)]})

    return spec, cpu, to(cpu, dev), ids, to


def _assert_shards_equal(a, b):
    import dataclasses

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        for p, q in zip(x if isinstance(x, tuple) else (x,), y if isinstance(y, tuple) else (y,)):
            assert torch.equal(_bits(p.cpu()), _bits(q.cpu())), f.name


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("kind,dtype", [("rowwise_adagrad", "float32"), ("adam", "bfloat16")])
def test_evict_pass_on_card_matches_cpu(window, kind, dtype):
    """LFU/TTL eviction, a full scan and a window of 100 of 512 buckets
    from bucket 450 (it wraps): the exports and every plane equal."""
    from meepoembedding_tpu_torch.kernels import row_gather, row_scatter_set
    from meepoembedding_tpu_torch.table import table_ops

    spec, cpu, gpu, _, _ = _lifecycle_pair(kind, dtype, evict_policy="lfu_ttl", lfu_min_freq=3,
                                           ttl_steps=25, max_evict_per_pass=4096,
                                           evict_scan_buckets=window)
    off = None if window is None else 450
    g0, s0 = row_gather.launches, row_scatter_set.launches
    got = table_ops.evict_pass(spec, gpu, 40, off)
    torch.cuda.synchronize()
    assert row_gather.launches - g0 == (2 if window is None else 3)
    assert row_scatter_set.launches - s0 == 2
    want = table_ops.evict_pass(spec, cpu, 40, off)
    assert got.count == want.count > 0
    for name in ("hi", "lo", "rows", "freq", "accum"):
        assert torch.equal(_bits(getattr(got, name).cpu()), _bits(getattr(want, name))), name
    for x, y in zip(got.fulldim, want.fulldim, strict=True):
        assert torch.equal(_bits(x.cpu()), _bits(y))
    _assert_shards_equal(gpu, cpu)


@pytest.mark.gpu
def test_erase_keys_and_invariants_on_card_match_cpu():
    from meepoembedding_tpu_torch.table import hashing, table_ops

    spec, cpu, gpu, ids, _ = _lifecycle_pair()
    q = torch.unique(torch.cat([ids[:5000], torch.arange(1, 3000)]))
    for shard in (gpu, cpu):
        hi, lo = hashing.split_ids_t(q.to(shard.key_hi.device))
        found = table_ops.erase_keys(spec, shard, hi, lo, hashing.is_valid(hi, lo))
        assert int(found.sum()) == 5000
    _assert_shards_equal(gpu, cpu)
    assert table_ops.check_invariants(spec, gpu, chunk_buckets=100) == \
        table_ops.check_invariants(spec, cpu) == dict.fromkeys(
            ("cnt_mismatch", "bad_placement", "dup_keys", "free_values_resid", "load_overflow"), 0)
    free = int((~hashing.is_valid(cpu.key_hi, cpu.key_lo)).view(-1).nonzero()[0, 0])
    for shard in (gpu, cpu):
        shard.values[free] = 2.0  # a free slot's values
        shard.cnt[3] += 1
    bad = table_ops.check_invariants(spec, gpu, chunk_buckets=100)
    assert bad == table_ops.check_invariants(spec, cpu)
    assert bad["cnt_mismatch"] == 1 and bad["free_values_resid"] == 1


@pytest.mark.gpu
def test_streamed_save_and_restore_on_card_match_cpu(tmp_path, monkeypatch):
    """A streamed save from the card writes the same part files as one from
    the CPU copy, and restoring them on the card gives the planes the CPU
    restore gives."""
    import os

    import numpy as np

    from meepoembedding_tpu_torch import checkpoint

    monkeypatch.setenv("MEEPO_CKPT_CHUNK_ROWS", "16384")
    spec, cpu, gpu, _, to = _lifecycle_pair("adam", "bfloat16")
    checkpoint.save(str(tmp_path / "g"), spec, [gpu], 40)
    checkpoint.save(str(tmp_path / "c"), spec, [cpu], 40)
    gdir = tmp_path / "g" / "step-40"
    names = sorted(os.listdir(gdir))
    assert names == sorted(os.listdir(tmp_path / "c" / "step-40"))
    assert sum(".part" in x for x in names) == 3
    for name in names:
        if name.endswith(".npz"):
            with np.load(gdir / name) as a, np.load(tmp_path / "c" / "step-40" / name) as b:
                assert a.files == b.files
                for k in a.files:
                    assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    (on_card,), _ = checkpoint.restore_shards(spec, str(tmp_path / "g"), 1, device="cuda")
    (on_cpu,), _ = checkpoint.restore_shards(spec, str(tmp_path / "c"), 1, device="cpu")
    _assert_shards_equal(on_card, on_cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["ctr_mlp", "dcn", "deepfm", "din", "bst", "two_tower"])
def test_zoo_train_steps_on_card_match_cpu(kind):
    """3 Trainer steps of each model kind on the card and on the CPU from
    one state: integer planes and counters equal, values, accumulators and
    loss within rtol 1e-5 / atol 1e-6, logits too (a two-tower's margins,
    differences of scores of magnitude tau, within atol 1e-5 * tau). The
    two-tower's tower is held still (dense lr 0): Adam turns its near-zero
    gradients into steps of ~lr whose sign is rounding."""
    from meepoembedding_tpu_torch.config import ModelConfig, RunConfig, TableConfig
    from meepoembedding_tpu_torch.data import SyntheticConfig, SyntheticStream
    from meepoembedding_tpu_torch.train import Trainer

    _cuda()
    mc = ModelConfig(kind=kind, num_dense_features=4, num_sparse_features=6, embedding_dim=16,
                     bottom_mlp=(32, 16), top_mlp=(32, 1), logq_correction=kind == "two_tower")
    bag = 5 if kind in ("din", "bst") else 1
    batches = list(SyntheticStream(SyntheticConfig(num_dense=4, num_sparse=6, batch_size=256,
                                                   seed=3, bag_len=bag)).batches(3))
    run = RunConfig(seed=1, dense_learning_rate=0.0 if kind == "two_tower" else 1e-3)
    trs = [Trainer(run, TableConfig(dim=16, capacity=1 << 14), mc, device=d)
           for d in ("cpu", "cuda")]
    out = [[(tr.train_step(b)["loss"], tr.last_logits.cpu()) for b in batches] for tr in trs]
    cpu, gpu = (tr.shard for tr in trs)
    for name in ("key_hi", "key_lo", "freq", "last", "cnt", "ovf", "counters"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name
    tol = dict(rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gpu.values.cpu(), cpu.values, **tol)
    torch.testing.assert_close(gpu.opt_rowwise[0].cpu(), cpu.opt_rowwise[0], **tol)
    torch.testing.assert_close(torch.tensor([o[0] for o in out[1]]),
                               torch.tensor([o[0] for o in out[0]]), **tol)
    atol = 1e-5 * float(torch.exp(trs[0].model.log_tau.detach())) if kind == "two_tower" else 1e-6
    torch.testing.assert_close(torch.stack([o[1] for o in out[1]]),
                               torch.stack([o[1] for o in out[0]]), rtol=1e-5, atol=atol)


@pytest.mark.gpu
def test_criteo_stream_parses_natively(tmp_path):
    from meepoembedding_tpu_torch.data import CriteoStream, PrefetchStream
    from meepoembedding_tpu_torch.data.criteo import write_synthetic_criteo

    _cuda()
    p = tmp_path / "s.tsv"
    write_synthetic_criteo(str(p), 256, seed=1)
    stream = PrefetchStream(CriteoStream(str(p), 64), depth=2)
    assert stream.parser == "native"
    assert len(list(stream.batches())) == 4


@pytest.mark.gpu
def test_cli_bench_update_on_card(capsys):
    import json

    from meepoembedding_tpu_torch import cli

    _cuda()
    before = {k.__name__: k.launches for k in (row_gather, row_scatter_add, row_merge_add)}
    assert cli.main(["bench-update", "--rows", "65536", "--batch", "4096", "--steps", "2"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "update_ids_per_sec_per_chip" and line["unit"] == "ids/s"
    assert line["rows"] == 65536 and line["value"] > 0 and line["ms_per_step"] > 0
    # 1 warm-up + 3 windows of 2 steps, each through the kernels
    for k in (row_gather, row_scatter_add, row_merge_add):
        assert k.launches - before[k.__name__] >= 7, k.__name__


@pytest.mark.gpu
def test_headline_harness_on_card(capsys):
    """The headline harness at a small table on the card: the reference's
    JSON keys, positive ratios, and every step through the kernels."""
    from meepoembedding_tpu_torch.bench import headline

    _cuda()
    before = {k.__name__: k.launches for k in (row_gather, row_scatter_add, row_merge_add)}
    got = headline.run(device="cuda", cap=1 << 18, batch=1 << 14, steps=2)
    assert list(got) == ["metric", "value", "unit", "vs_baseline", "vs_sol_unique"]
    assert got["metric"] == "lookup_update_ids_per_sec_per_chip" and got["value"] > 0
    assert got["vs_baseline"] > 0 and got["vs_sol_unique"] > 0
    assert capsys.readouterr().err.splitlines()[0] != "cpu"  # the card's line first
    # 1 warm-up + 3 windows of 2 steps of each of the three arms
    for k in (row_gather, row_scatter_add, row_merge_add):
        assert k.launches - before[k.__name__] >= 7, k.__name__


# --- K6 / K7: the DMA probe's random-row block copies -----------------------------

DMA_GATHER = ((1, 2, 4, 8, 16, 32), (8, 32, 128, 256))  # bench_dma.py's sweep
DMA_SCATTER = ((1, 4, 16), (32, 256))


def _dma_bases(nrow: int, n: int, R: int, g, dev) -> torch.Tensor:
    """n random bases with the clip edge at the front: below 0, at and
    above nrow - R, the int32 extremes."""
    base = torch.randint(0, nrow, (n,), device=dev, dtype=torch.int32, generator=g)
    edge = [-(2**31), -1, 0, nrow - R, nrow - 1, nrow, 2**31 - 1, *range(nrow - R, nrow)]
    base[:len(edge)] = torch.tensor(edge, dtype=torch.int32, device=dev)
    return base


@pytest.mark.gpu
@pytest.mark.parametrize("R", DMA_GATHER[0])
def test_row_block_gather_matches_plain(R):
    """Every W of the sweep (capped to the ring that fits) gives the plain
    version's bits, over a ragged last block and the clip edge."""
    from meepoembedding_tpu_torch.kernels import row_block_copy as rbc

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(R)
    nrow, n = 1 << 20, 4096 + 77
    plane = torch.randn((nrow, 128), device=dev, generator=g)
    base = _dma_bases(nrow, n, R, g, dev)
    want = rbc.row_block_gather_plain(plane, base, R)
    before = rbc.row_block_gather.launches
    for W in DMA_GATHER[1]:
        w = min(W, rbc.max_ring(R))
        got = rbc.row_block_gather(plane, base, R, w)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(want)), (R, W, w)
        assert rbc.occupancy(R, w) >= 1
    assert rbc.row_block_gather.launches == before + len(DMA_GATHER[1])


@pytest.mark.gpu
@pytest.mark.parametrize("R", DMA_SCATTER[0])
def test_row_block_scatter_matches_plain(R):
    """Disjoint blocks (distinct multiples of 16, the top one included) of
    random rows: every W of the sweep, capped, gives the plain version's
    bits, and the same bits as each other."""
    from meepoembedding_tpu_torch.kernels import row_block_copy as rbc

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(100 + R)
    nrow, n = 1 << 20, 4096 + 77
    plane = torch.randn((nrow, 128), device=dev, generator=g)
    base = (torch.randperm(nrow // 16, device=dev, generator=g)[:n] * 16).int()
    base[0] = nrow - 16
    upd = torch.randn((n * R, 128), device=dev, generator=g)
    want = rbc.row_block_scatter_plain(plane.clone(), base, upd, R)
    for W in DMA_SCATTER[1]:
        got = rbc.row_block_scatter(plane.clone(), base, upd, R, min(W, rbc.max_ring(R)))
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(want)), (R, W)


@pytest.mark.gpu
@pytest.mark.parametrize("W", (1, 2, 3, 5, 17, 100, 255))
def test_row_block_copy_any_ring(W):
    """Rings outside the sweep, dealt out unevenly over the eight issuing
    lanes of a block (W < 8: W lanes): the plain version's bits, the gather
    over the clip edge, the scatter on disjoint blocks."""
    from meepoembedding_tpu_torch.kernels import row_block_copy as rbc

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(200 + W)
    nrow, n, R = 1 << 16, 1024 + 33, 1
    plane = torch.randn((nrow, 128), device=dev, generator=g)
    base = _dma_bases(nrow, n, R, g, dev)
    got = rbc.row_block_gather(plane, base, R, W)
    assert torch.equal(_bits(got), _bits(rbc.row_block_gather_plain(plane, base, R)))
    base = torch.randperm(nrow, device=dev, generator=g)[:n].int()
    upd = torch.randn((n * R, 128), device=dev, generator=g)
    got = rbc.row_block_scatter(plane.clone(), base, upd, R, W)
    want = rbc.row_block_scatter_plain(plane.clone(), base, upd, R)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.gpu
def test_row_block_copy_refuses_on_card():
    from meepoembedding_tpu_torch.kernels import row_block_copy as rbc

    dev = _cuda()
    plane = torch.zeros((1024, 128), device=dev)
    base = torch.zeros((8,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        rbc.row_block_gather(plane, base, 32, 32)
    with pytest.raises(ValueError, match="shared memory"):
        rbc.occupancy(16, 256)
    with pytest.raises(ValueError, match="one device"):
        rbc.row_block_gather(plane.cpu(), base, 1, 8)
    with pytest.raises(ValueError, match="one device"):
        rbc.row_block_scatter(plane, base, torch.zeros((8, 128)), 1, 8)
    with pytest.raises(ValueError, match="aligned"):
        rbc.row_block_gather(plane.view(-1)[1:1 + 512 * 128].view(512, 128), base, 1, 8)
