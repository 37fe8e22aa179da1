"""Parity of the port's `unique_pairs` with the JAX reference: unique order,
inverse, validity and count must be identical, including the overflow
aliasing, the owner-major order and the invalid-id tie quirk."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meepoembedding_tpu.ops import dedup as jd
from meepoembedding_tpu.table import hashing as jh
from meepoembedding_tpu_torch.ops import dedup as td

torch.set_num_threads(1)


def _batch(seed: int, n: int) -> np.ndarray:
    """Ids with heavy duplication, invalid padding, negative ids and the id
    that ties with the invalid sentinel in the biased sort order."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(-(2**63), 2**63 - 1, size=max(4, n // 4), dtype=np.int64)
    pool[:4] = [0x7FFFFFFF_00000000, -1, 0, 2**31]
    ids = rng.choice(pool, size=n)
    ids[rng.random(n) < 0.1] = jh.EMPTY_ID
    return ids


def _compare(ids, size, owner_major=0):
    hi, lo = jh.split_ids(ids)
    want = jd.unique_pairs(jnp.asarray(hi), jnp.asarray(lo), size, owner_major=owner_major)
    got = td.unique_pairs(torch.from_numpy(hi), torch.from_numpy(lo), size,
                          owner_major=owner_major)
    for name in ("hi", "lo", "inverse", "valid", "count"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name
        )
    return got


@pytest.mark.parametrize("n", [1, 7, 1024, 4096])
def test_unique_pairs_matches(n):
    got = _compare(_batch(n, n), size=n)
    assert int(got.count) <= n


def test_unique_pairs_overflow_aliases_last_slot():
    ids = _batch(11, 2048)
    true_uniques = len(np.unique(ids))
    size = true_uniques // 2
    got = _compare(ids, size=size)
    assert int(got.inverse.max()) == size - 1


def test_unique_pairs_size_above_batch():
    _compare(_batch(12, 300), size=512)


@pytest.mark.parametrize("shards", [2, 3, 8])
def test_unique_pairs_owner_major(shards):
    _compare(_batch(13 + shards, 2048), size=2048, owner_major=shards)
