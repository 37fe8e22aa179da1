"""Bucket probe of the dynamic table: the whole of `table_ops.probe` in one
launch (no TPU kernel: the JAX package's probe,
meepoembedding_tpu/table/xla_ops.py:59, is plain XLA code).

    bucket_probe(key_hi, key_lo, uh, ul, valid, rounds) -> (slot, found)

For [nb, 128] int32 key planes (nb a power of two) and [n] int32 keys with a
[n] bool mask: the slot (b * 128 + lane, int32, -1 if absent) and whether
the key was found, walking the buckets of XOR pair probing in order: for
g = 0 .. ceil(R / 2) - 1, with R = min(rounds, nb), b0 the key's home bucket
(`hashing.bucket_of`) and p0 = b0 >> 1, bucket 2 (p0 ^ g), then
2 (p0 ^ g) + 1; bucket 0 alone where nb == 1. The first bucket that holds
the key wins, and in it the lowest lane; an invalid key gives -1, not found.

`bucket_probe_plain` is the port's pair probing in plain PyTorch: one
`row_gather_multi` of both key planes, viewed as [nb / 2, 256] bucket
pairs, a round group, and broadcast compares. It is the kernel's reference.

The kernel (`csrc/bucket_probe.cu`, a warp a key) is bound by device memory:
(14 n + 512 x buckets visited + 16 x hits) bytes / 3.35 TB/s on an H100 SXM.
The wrapper counts its launches in `bucket_probe.launches`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from meepoembedding_tpu_torch.kernels import _build
from meepoembedding_tpu_torch.kernels.row_gather import row_gather_multi
from meepoembedding_tpu_torch.table import hashing

LANES = 128
MAX_BUCKETS = 1 << 24  # slots b * 128 + lane stay below 2^31


def first_true(m: torch.Tensor) -> torch.Tensor:
    """Per row, the first True lane of a [n, 128] mask (0 if none), as the
    reference's `argmax` over booleans gives it."""
    return torch.argmax(m.to(torch.uint8), dim=1).to(torch.int32)


def bucket_probe_plain(key_hi: torch.Tensor, key_lo: torch.Tensor, uh: torch.Tensor,
                       ul: torch.Tensor, valid: torch.Tensor,
                       rounds: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: the reference for the kernel. Rounds 2g
    and 2g+1 share one aligned bucket pair, so one launch that gathers
    [n, 256] rows of both key planes serves two rounds."""
    nb = key_hi.shape[0]
    b0 = hashing.bucket_of(uh, ul, nb)
    n = uh.shape[0]
    rounds = min(rounds, nb)
    slot = torch.full((n,), -1, dtype=torch.int32, device=uh.device)
    found = torch.zeros((n,), dtype=torch.bool, device=uh.device)
    if nb == 1:
        m = (key_hi[0][None, :] == uh[:, None]) & (key_lo[0][None, :] == ul[:, None])
        hit = m.any(dim=1) & valid
        return torch.where(hit, first_true(m), -1), hit
    hi_pair = key_hi.view(nb // 2, 2 * LANES)
    lo_pair = key_lo.view(nb // 2, 2 * LANES)
    p0 = b0 >> 1
    uh_c, ul_c = uh[:, None], ul[:, None]
    for g in range((rounds + 1) // 2):
        # an odd `rounds` probes one extra bucket: harmless, nothing is ever
        # stored beyond a key's insert rounds
        pg = p0 ^ g
        row_h, row_l = row_gather_multi((hi_pair, lo_pair), pg)
        m_e = (row_h[:, :LANES] == uh_c) & (row_l[:, :LANES] == ul_c)
        m_o = (row_h[:, LANES:] == uh_c) & (row_l[:, LANES:] == ul_c)
        hit_e = m_e.any(dim=1) & valid
        hit_o = m_o.any(dim=1) & valid
        slot_g = torch.where(hit_e, pg * (2 * LANES) + first_true(m_e),
                             (pg * 2 + 1) * LANES + first_true(m_o))
        hit = hit_e | hit_o
        slot = torch.where(hit & ~found, slot_g, slot)
        found = found | hit
    return slot, found


_fns: dict = {}


def _fn():
    fn = _fns.get("probe")
    if fn is None:
        fn = _build.load("bucket_probe").meepo_bucket_probe
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["probe"] = fn
    return fn


def bucket_probe(key_hi: torch.Tensor, key_lo: torch.Tensor, uh: torch.Tensor,
                 ul: torch.Tensor, valid: torch.Tensor,
                 rounds: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[nb, 128] contiguous int32 key planes (nb a power of two), [n] int32
    keys and a [n] bool mask -> (slot int32 [n], found bool [n]), probing
    min(rounds, nb) rounds. CPU tensors take the plain version; tensors on
    one CUDA device launch the kernel; any other mix raises."""
    nb = key_hi.shape[0] if key_hi.dim() == 2 else 0
    for name, p in (("key_hi", key_hi), ("key_lo", key_lo)):
        if (p.dtype != torch.int32 or tuple(p.shape) != (nb, LANES) or not p.is_contiguous()):
            raise ValueError(f"bucket_probe: {name} must be a contiguous [nb, {LANES}] int32 "
                             f"plane, got {tuple(p.shape)} {p.dtype}")
    if nb & (nb - 1) or not 1 <= nb <= MAX_BUCKETS:
        raise ValueError(f"bucket_probe: nb must be a power of two in [1, {MAX_BUCKETS}], "
                         f"got {nb}")
    n = uh.shape[0]
    for name, k, dtype in (("uh", uh, torch.int32), ("ul", ul, torch.int32),
                           ("valid", valid, torch.bool)):
        if k.dtype != dtype or k.dim() != 1 or k.shape[0] != n:
            raise ValueError(f"bucket_probe: {name} must be [{n}] {dtype}, got "
                             f"{tuple(k.shape)} {k.dtype}")
    dev = uh.device
    if any(t.device != dev for t in (key_hi, key_lo, ul, valid)):
        raise ValueError("bucket_probe: the planes, keys and mask lie on one CUDA device "
                         "(or all on the CPU)")
    if dev.type == "cpu":
        return bucket_probe_plain(key_hi, key_lo, uh, ul, valid, rounds)
    if dev.type != "cuda":
        raise ValueError(f"bucket_probe: tensors on {dev}, not a CUDA device or the CPU")
    if (key_hi.data_ptr() | key_lo.data_ptr()) % 16:
        raise ValueError("bucket_probe: the key planes must be 16-byte aligned")
    uh, ul, valid = uh.contiguous(), ul.contiguous(), valid.contiguous()
    slot = torch.empty((n,), dtype=torch.int32, device=dev)
    found = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return slot, found
    err = _fn()(key_hi.data_ptr(), key_lo.data_ptr(), uh.data_ptr(), ul.data_ptr(),
                valid.data_ptr(), slot.data_ptr(), found.data_ptr(), n, nb,
                max(0, (min(rounds, nb) + 1) // 2), _build.raw_stream(dev))
    if err:
        _build.check(_build.load("bucket_probe"), err, "bucket_probe")
    bucket_probe.launches += 1
    return slot, found


bucket_probe.launches = 0
