"""Stateless uint32 hashing of 64-bit feature ids (port of
`meepoembedding_tpu/table/hashing.py:18-86`).

An id `k` lives on the device as a pair of int32 tensors (hi = k >> 32,
lo = k & 0xffffffff), exactly as in the reference, so every hash, bucket
and unique order is bit-identical to it. PyTorch has no general uint32
arithmetic, so the uint32 math runs in int64 holding values in [0, 2^32):
each multiply is split into 16-bit halves (no product exceeds 2^48, so no
signed overflow) and masked with 0xFFFFFFFF.

The int64 value INT64_MIN is reserved as the invalid/padding id.
"""

from __future__ import annotations

import numpy as np
import torch

EMPTY_HI = -(2**31)
EMPTY_LO = 0
EMPTY_ID = np.int64(-(2**63))

SALT_BUCKET = 0x2545F491
SALT_OWNER = 0x9E3779B9
SALT_INIT = 0x85EBCA6B
SALT_CMS = (0xC2B2AE35, 0x27D4EB2F, 0x165667B1, 0xD3A2646C)

M32 = 0xFFFFFFFF


def split_ids(ids64: np.ndarray):
    """Host-side: int64 ids -> (hi, lo) int32 numpy arrays."""
    ids64 = np.asarray(ids64, dtype=np.int64)
    hi = (ids64 >> np.int64(32)).astype(np.int32)
    lo = (ids64 & np.int64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    return hi, lo


def join_ids(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Host-side inverse of split_ids."""
    hi = np.asarray(hi, dtype=np.int64) << np.int64(32)
    lo = np.asarray(lo, dtype=np.int32).view(np.uint32).astype(np.int64)
    return hi | lo


def split_ids_t(ids64: torch.Tensor):
    """Device-side split_ids: int64 tensor -> (hi, lo) int32 tensors."""
    hi = (ids64 >> 32).to(torch.int32)
    # sign-extend the low word before narrowing, so the cast is exact
    lo = (((ids64 & M32) ^ 0x80000000) - 0x80000000).to(torch.int32)
    return hi, lo


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 -> its uint32 value held in int64."""
    return x.to(torch.int64) & M32


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for h in [0, 2^32) held in int64."""
    lo_part = h * (c & 0xFFFF)
    hi_part = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo_part + hi_part) & M32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def hash_pair(hi: torch.Tensor, lo: torch.Tensor, salt: int) -> torch.Tensor:
    """uint32 hash (held in int64) of an (hi, lo) id pair under a salt."""
    uhi, ulo = _u32(hi), _u32(lo)
    h = _mul32(ulo, 0xCC9E2D51) ^ _mul32(uhi, 0x1B873593) ^ salt
    return fmix32(h ^ (fmix32(uhi) >> 1))


def bucket_of(hi, lo, num_buckets: int) -> torch.Tensor:
    """Home bucket (num_buckets a power of two) as int32."""
    return (hash_pair(hi, lo, SALT_BUCKET) & (num_buckets - 1)).to(torch.int32)


def owner_of(hi, lo, num_shards: int) -> torch.Tensor:
    """Owning shard of an id, as int32."""
    h = hash_pair(hi, lo, SALT_OWNER)
    if num_shards & (num_shards - 1) == 0:
        if num_shards == 1:
            return torch.zeros_like(hi, dtype=torch.int32)
        shift = 32 - num_shards.bit_length() + 1
        return (h >> shift).to(torch.int32)
    return (h % num_shards).to(torch.int32)


def is_valid(hi, lo) -> torch.Tensor:
    """False for the reserved invalid/pad id."""
    return ~((hi == EMPTY_HI) & (lo == EMPTY_LO))
