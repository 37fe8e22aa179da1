"""Parity of the port's id hashing with the JAX reference: every hash, bucket,
owner and validity flag must be bit-identical (slot placement depends on
them)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meepoembedding_tpu.table import hashing as jh
from meepoembedding_tpu_torch.table import hashing as th

torch.set_num_threads(1)

SPECIALS = np.array(
    [jh.EMPTY_ID, 0x7FFFFFFF_00000000, -1, 0, 1, 2**31, -(2**31), 2**32 - 1,
     2**63 - 1, -(2**63) + 1, -(2**63) + 0x7FFFFFFF],
    dtype=np.int64,
)


def _ids(seed: int, n: int = 4096) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ids = rng.integers(-(2**63), 2**63 - 1, size=n, dtype=np.int64, endpoint=True)
    ids[: len(SPECIALS)] = SPECIALS
    return ids


def _halves(ids):
    hi, lo = jh.split_ids(ids)
    return (jnp.asarray(hi), jnp.asarray(lo)), (torch.from_numpy(hi), torch.from_numpy(lo))


def test_split_ids_device_matches_host():
    ids = _ids(0)
    hi, lo = jh.split_ids(ids)
    thi, tlo = th.split_ids_t(torch.from_numpy(ids))
    np.testing.assert_array_equal(thi.numpy(), hi)
    np.testing.assert_array_equal(tlo.numpy(), lo)
    np.testing.assert_array_equal(th.join_ids(*th.split_ids(ids)), ids)


def test_fmix32_matches():
    rng = np.random.default_rng(1)
    u = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    u[:3] = [0, 1, 0xFFFFFFFF]
    want = np.asarray(jh.fmix32(jnp.asarray(u)))
    got = th.fmix32(torch.from_numpy(u.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("salt", [jh.SALT_BUCKET, jh.SALT_OWNER, jh.SALT_INIT, *jh.SALT_CMS])
def test_hash_pair_matches(salt):
    (jhi, jlo), (thi, tlo) = _halves(_ids(2))
    want = np.asarray(jh.hash_pair(jhi, jlo, salt)).astype(np.int64)
    np.testing.assert_array_equal(th.hash_pair(thi, tlo, int(salt)).numpy(), want)


@pytest.mark.parametrize("nb", [1, 2, 64, 1 << 20])
def test_bucket_of_matches(nb):
    (jhi, jlo), (thi, tlo) = _halves(_ids(3))
    got = th.bucket_of(thi, tlo, nb)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jh.bucket_of(jhi, jlo, nb)))


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 6, 8])
def test_owner_of_matches(shards):
    (jhi, jlo), (thi, tlo) = _halves(_ids(4))
    np.testing.assert_array_equal(
        th.owner_of(thi, tlo, shards).numpy(), np.asarray(jh.owner_of(jhi, jlo, shards))
    )


def test_is_valid_matches():
    (jhi, jlo), (thi, tlo) = _halves(_ids(5))
    got = th.is_valid(thi, tlo).numpy()
    np.testing.assert_array_equal(got, np.asarray(jh.is_valid(jhi, jlo)))
    assert not got[0] and got[1:].all()
