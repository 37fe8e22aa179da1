"""Streams of randomness derived from a run's `--seed`.

Each consumer (traffic, weights, fill rows, samples) draws from its own
stream, so adding a draw to one leaves the others as they were. `--seed` is
any integer; it is taken modulo 2**64.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch


def derive(seed: int, stream: str) -> int:
    """A 63-bit seed for `stream` of the run seeded `seed`."""
    ss = np.random.SeedSequence([int(seed) % 2**64, zlib.crc32(stream.encode())])
    return int(ss.generate_state(1, np.uint64)[0]) & (2**63 - 1)


def rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(derive(seed, stream))


def torch_gen(seed: int, stream: str, device) -> torch.Generator:
    """A generator on `device` (on the card for a CUDA device)."""
    return torch.Generator(device=device).manual_seed(derive(seed, stream))
