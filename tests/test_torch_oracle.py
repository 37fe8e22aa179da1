"""The port's float64 dict oracle (`meepoembedding_tpu_torch.table.oracle`)
against the JAX package's (`meepoembedding_tpu.table.oracle`).

Both run the same seeded sequence of lookups (train and eval, duplicate
ids, the invalid id), gradient updates, removals and eviction passes, for
every optimizer and every initializer, under frequency admission and an
LFU/TTL policy. Each lookup's rows, each removal's count and each eviction's
exported rows, and at the end every row, optimizer state and counter, are
equal. The uniform and constant initializers give the same bits on both
sides, so those cases are exact; the normal ones go through `erfinv`,
whose torch and JAX versions differ in the last places of a float32, so
there rows are held within the tolerance the port's other tests give
those inits (rtol 1e-5 / atol 1e-6), carried through the float64 updates.
"""

import numpy as np
import pytest
import torch

from meepoembedding_tpu import config as jcfg
from meepoembedding_tpu.table.oracle import OracleTable as JaxOracle
from meepoembedding_tpu_torch import config as tcfg
from meepoembedding_tpu_torch.table import hashing
from meepoembedding_tpu_torch.table.oracle import OracleTable

torch.set_num_threads(1)

DIM = 8
POLICY = dict(admit_threshold=2, evict_policy="lfu_ttl", ttl_steps=2, lfu_min_freq=2)


def _both(kind: str, init: str):
    opt = dict(kind=kind, learning_rate=0.1, l1=0.01 if kind == "ftrl" else 0.0)
    return (JaxOracle(DIM, 0.05, jcfg.OptimizerConfig(**opt), jcfg.PolicyConfig(**POLICY),
                      init_kind=init),
            OracleTable(DIM, 0.05, tcfg.OptimizerConfig(**opt), tcfg.PolicyConfig(**POLICY),
                        init_kind=init))


def _close(a, b, exact: bool) -> None:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if exact:
        assert np.array_equal(a, b)
    else:
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


def _same_state(want, got, exact: bool) -> None:
    assert (got.hits, got.misses, len(got)) == (want.hits, want.misses, len(want))
    assert got.freq == want.freq and got.last == want.last and got.seen == want.seen
    for name in ("rows", "accum", "m"):
        w, g = getattr(want, name), getattr(got, name)
        assert sorted(g) == sorted(w), name
        for k in w:
            _close(w[k], g[k], exact)


@pytest.mark.parametrize("kind, init", [
    *[(k, "uniform") for k in ("sgd", "momentum", "rowwise_adagrad", "adagrad", "adam", "ftrl")],
    ("rowwise_adagrad", "normal"), ("adam", "truncated_normal"), ("sgd", "constant")])
def test_oracle_matches_jax_oracle(kind, init):
    exact = init in ("uniform", "constant")
    want, got = _both(kind, init)
    rng = np.random.default_rng(7)
    pool = rng.integers(-(2**62), 2**62, size=40, dtype=np.int64)
    for step in range(8):
        keys = pool[rng.integers(0, len(pool), size=24)]
        keys[rng.random(24) < 0.1] = hashing.EMPTY_ID
        train = step % 4 != 3
        _close(want.lookup(keys, step, train), got.lookup(keys, step, train), exact)
        grads = rng.normal(size=(24, DIM))
        want.apply_grads(keys, grads)
        got.apply_grads(keys, grads)
        if step % 3 == 2:
            gone = pool[rng.integers(0, len(pool), size=5)]
            assert got.remove(gone) == want.remove(gone)
        if step % 2 == 1:
            w_ev, g_ev = want.evict(step), got.evict(step)
            assert sorted(g_ev) == sorted(w_ev)
            for k in w_ev:
                _close(w_ev[k], g_ev[k], exact)
        _same_state(want, got, exact)
    assert len(got) > 0 and got.misses > 0 and got.hits > 0
