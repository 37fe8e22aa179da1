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
