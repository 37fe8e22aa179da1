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
    row_gather_plain,
    row_merge_add,
    row_merge_add_plain,
    row_scatter_add,
    row_scatter_add_plain,
    row_scatter_set,
    row_scatter_set_plain,
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
@pytest.mark.parametrize("width", [8, 32, 40, 256])
def test_row_merge_add_matches_plain(dtype, width):
    """Unique rows: bit-exact. Duplicate rows: the plain version adds them
    with atomics in no fixed order, so within the bound of two summation
    orders (`_order_bound`), and the kernel gives the same bits on two
    launches."""
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
    first, again, plain = base.clone(), base.clone(), base.clone()
    row_merge_add(first, vrow, upd)
    row_merge_add(again, vrow, upd)
    row_merge_add_plain(plain, vrow, upd)
    torch.cuda.synchronize()
    assert torch.equal(_bits(first), _bits(again))
    assert_within_order_bound(first, plain, _order_bound(base, vrow, upd))


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
