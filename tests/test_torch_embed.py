"""The port's `embed.lookup` / `update` / `update_window` against the JAX
package's `embed`, on the same ids from one (empty) state.

Exact: key, freq, last, cnt, ovf planes and counters (so every slot,
insert and drop), and the unique ids' order. Within rtol 1e-5 / atol 1e-6:
`emb`, values and optimizer state (segment sums in another order; the
reference's rowwise accumulator sums g^2 over 128 window lanes)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_train_parity import TOL, assert_tables_match

from meepoembedding_tpu import embed as jembed
from meepoembedding_tpu.config import OptimizerConfig as JOptimizerConfig
from meepoembedding_tpu.config import TableConfig as JTableConfig
from meepoembedding_tpu.table import hashing as jh
from meepoembedding_tpu.table.layout import TableSpec as JTableSpec
from meepoembedding_tpu.table.layout import alloc_shard as jalloc_shard
from meepoembedding_tpu_torch import embed
from meepoembedding_tpu_torch.config import OptimizerConfig, TableConfig
from meepoembedding_tpu_torch.table import hashing
from meepoembedding_tpu_torch.table.layout import TableSpec, alloc_shard

torch.set_num_threads(1)


def specs(dim=16, nb=64, **opt):
    table = dict(dim=dim, capacity=nb * 128, max_probe_rounds=2)
    return (JTableSpec.from_config(JTableConfig(**table, optimizer=JOptimizerConfig(**opt))),
            TableSpec.from_config(TableConfig(**table, optimizer=OptimizerConfig(**opt))))


def jax_step(spec, w, unique_cap=None):
    """The reference's user step: loss = 0.5 * w * sum(emb^2)."""

    @partial(jax.jit, donate_argnums=(0,))
    def f(shard, hi, lo, step):
        shard, ctx, emb = jembed.lookup(spec, shard, hi, lo, step, unique_cap=unique_cap)
        g = jax.grad(lambda e: 0.5 * w * jnp.sum(e ** 2))(emb)
        return jembed.update(spec, shard, ctx, g), emb, ctx.count

    return f


def torch_step(spec, shard, ids, step, w, unique_cap=None):
    hi, lo = hashing.split_ids_t(torch.from_numpy(ids))
    ctx, emb = embed.lookup(spec, shard, hi, lo, step, unique_cap=unique_cap)
    (g,) = torch.autograd.grad(0.5 * w * (emb ** 2).sum(), [emb])
    embed.update(spec, shard, ctx, g)
    return emb.detach(), ctx


jlookup = jax.jit(jembed.lookup, static_argnums=(0,), static_argnames=("unique_cap", "train"))
jupdate = jax.jit(jembed.update, static_argnums=(0,))


def jsplit(ids):
    hi, lo = jh.split_ids(ids)
    return jnp.asarray(hi), jnp.asarray(lo)


@pytest.mark.parametrize("kind", ["sgd", "rowwise_adagrad", "adagrad", "adam"])
def test_grad_update_matches_jax(kind):
    jspec, tspec = specs(kind=kind, learning_rate=0.1)
    jshard, tshard = jalloc_shard(jspec), alloc_shard(tspec, "cpu")
    f = jax_step(jspec, 0.7)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 50, size=96, dtype=np.int64)  # heavy duplicates
    for step in range(3):
        jshard, jemb, _ = f(jshard, *jsplit(ids), jnp.int32(step))
        temb, _ = torch_step(tspec, tshard, ids, step, 0.7)
        np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), **TOL,
                                   err_msg=f"step {step}")
        ids = np.concatenate([ids[32:], rng.integers(0, 50, 32, np.int64)])
    assert_tables_match(jspec, jshard, tshard)
    probe = np.arange(60, dtype=np.int64)
    _, _, jemb = jlookup(jspec, jshard, *jsplit(probe), jnp.int32(9), train=False)
    hi, lo = hashing.split_ids_t(torch.from_numpy(probe))
    _, temb = embed.lookup(tspec, tshard, hi, lo, 9, train=False)
    np.testing.assert_allclose(temb.detach().numpy(), np.asarray(jemb), **TOL)


def test_duplicates_segment_sum():
    """id 7 three times, id 9 once: one unit-grad SGD step moves row 7 three
    times as far, in both packages."""
    jspec, tspec = specs(dim=8, kind="sgd", learning_rate=1.0)
    jshard, tshard = jalloc_shard(jspec), alloc_shard(tspec, "cpu")
    ids = np.array([7, 7, 7, 9], np.int64)
    jshard, jctx, jemb = jlookup(jspec, jshard, *jsplit(ids), jnp.int32(0))
    jshard = jupdate(jspec, jshard, jctx, jnp.ones_like(jemb))
    hi, lo = hashing.split_ids_t(torch.from_numpy(ids))
    ctx, emb = embed.lookup(tspec, tshard, hi, lo, 0)
    embed.update(tspec, tshard, ctx, torch.ones_like(emb))
    np.testing.assert_array_equal(ctx.inverse.numpy(), np.asarray(jctx.inverse))
    assert int(ctx.count) == int(jctx.count) == 2
    _, after = embed.lookup(tspec, tshard, hi, lo, 1, train=False)
    np.testing.assert_allclose((emb - after).detach().numpy()[[0, 3]],
                               [[3.0] * 8, [1.0] * 8], rtol=1e-6)
    assert_tables_match(jspec, jshard, tshard)


def test_batch_shape_and_padding():
    jspec, tspec = specs(dim=16, kind="rowwise_adagrad", learning_rate=0.1)
    jshard, tshard = jalloc_shard(jspec), alloc_shard(tspec, "cpu")
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 100, size=(4, 3), dtype=np.int64)
    ids[1, 2] = hashing.EMPTY_ID  # bag padding
    jshard, jctx, jemb = jlookup(jspec, jshard, *jsplit(ids), jnp.int32(0))
    jshard = jupdate(jspec, jshard, jctx, jnp.ones_like(jemb))
    hi, lo = hashing.split_ids_t(torch.from_numpy(ids))
    ctx, emb = embed.lookup(tspec, tshard, hi, lo, 0)
    assert emb.shape == (4, 3, 16) and emb.dtype == torch.float32 and emb.requires_grad
    assert not emb[1, 2].any()
    embed.update(tspec, tshard, ctx, torch.ones_like(emb))  # the padding's grad is dropped
    np.testing.assert_allclose(emb.detach().numpy(), np.asarray(jemb), **TOL)
    assert_tables_match(jspec, jshard, tshard)


def test_eval_inserts_nothing():
    jspec, tspec = specs(dim=16, kind="sgd", learning_rate=0.1)
    tshard = alloc_shard(tspec, "cpu")
    ids = np.random.default_rng(3).integers(0, 40, size=32, dtype=np.int64)
    hi, lo = hashing.split_ids_t(torch.from_numpy(ids))
    _, emb = embed.lookup(tspec, tshard, hi, lo, 0, train=False)
    assert not emb.any() and int(tshard.cnt.sum()) == 0 and not tshard.counters.any()
    # a train lookup paired with a zero-grad update materialises the inits,
    # which the eval lookup then reads
    ctx, emb1 = embed.lookup(tspec, tshard, hi, lo, 1)
    embed.update(tspec, tshard, ctx, torch.zeros_like(emb1))
    _, emb2 = embed.lookup(tspec, tshard, hi, lo, 2, train=False)
    np.testing.assert_array_equal(emb1.detach().numpy(), emb2.detach().numpy())
    jshard = jalloc_shard(jspec)
    jshard, jctx, jemb1 = jlookup(jspec, jshard, *jsplit(ids), jnp.int32(1))
    np.testing.assert_allclose(emb1.detach().numpy(), np.asarray(jemb1), **TOL)


def test_dim_gt_128_paired_equal_unpaired_differs():
    """dim 256: paired lookup/update steps agree with the reference. An
    unpaired train lookup differs on purpose: the reference writes the init
    rows at lookup for dim > 128, the port (one regime for every dim) only
    in `update`, so its fresh keys read zero rows until then."""
    jspec, tspec = specs(dim=256, nb=16, kind="sgd", learning_rate=0.5)
    jshard, tshard = jalloc_shard(jspec), alloc_shard(tspec, "cpu")
    f = jax_step(jspec, 1.0)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 30, size=48, dtype=np.int64)
    for step in range(2):
        jshard, jemb, _ = f(jshard, *jsplit(ids), jnp.int32(step))
        temb, _ = torch_step(tspec, tshard, ids, step, 1.0)
        np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), **TOL)
        ids = rng.integers(0, 30, size=48, dtype=np.int64)
    assert_tables_match(jspec, jshard, tshard)

    new = np.array([1000, 1001], np.int64)  # unpaired train lookup of fresh ids
    jshard, _, jfresh = jlookup(jspec, jshard, *jsplit(new), jnp.int32(5))
    hi, lo = hashing.split_ids_t(torch.from_numpy(new))
    _, tfresh = embed.lookup(tspec, tshard, hi, lo, 5)
    np.testing.assert_allclose(tfresh.detach().numpy(), np.asarray(jfresh), **TOL)
    _, _, jread = jlookup(jspec, jshard, *jsplit(new), jnp.int32(6), train=False)
    _, tread = embed.lookup(tspec, tshard, hi, lo, 6, train=False)
    np.testing.assert_allclose(np.asarray(jread), np.asarray(jfresh), **TOL)  # init
    assert not tread.any()  # zeros


def test_update_window_equals_update():
    """update_window from per-unique grads (rows_u.grad after backward) ==
    update from batch-order grads, and both equal the reference's
    update_window."""
    jspec, tspec = specs(dim=16, kind="rowwise_adagrad", learning_rate=0.1)
    ids = np.random.default_rng(5).integers(0, 60, size=64, dtype=np.int64)
    hi, lo = hashing.split_ids_t(torch.from_numpy(ids))
    shard_a, shard_b = alloc_shard(tspec, "cpu"), alloc_shard(tspec, "cpu")
    ctx, emb = embed.lookup(tspec, shard_a, hi, lo, 0)
    embed.update(tspec, shard_a, ctx, 0.3 * emb.detach())
    ctx_b, emb_b = embed.lookup(tspec, shard_b, hi, lo, 0)
    (0.5 * 0.3 * (emb_b ** 2).sum()).backward()
    embed.update_window(tspec, shard_b, ctx_b, ctx_b.rows_u.grad)
    np.testing.assert_allclose(shard_b.values.numpy(), shard_a.values.numpy(),
                               rtol=1e-6, atol=1e-7)

    from meepoembedding_tpu.table import xla_ops as jx

    jshard = jalloc_shard(jspec)
    jshard, jctx, _ = jlookup(jspec, jshard, *jsplit(ids), jnp.int32(0))

    def loss_fn(g128):
        return 0.5 * 0.3 * jnp.sum(jx.rows_for_batch(jspec, g128, jctx.sub, jctx.inverse) ** 2)

    jshard = jembed.update_window(jspec, jshard, jctx, jax.grad(loss_fn)(jctx.g128))
    assert_tables_match(jspec, jshard, shard_b)


def test_unique_cap_aliases_as_the_reference():
    """A cap below the unique count aliases the overflow ids onto the last
    unique slot in both packages: same count, inverse, rows and table."""
    jspec, tspec = specs(dim=8, kind="sgd", learning_rate=0.2)
    jshard, tshard = jalloc_shard(jspec), alloc_shard(tspec, "cpu")
    ids = np.random.default_rng(6).integers(0, 40, size=32, dtype=np.int64)
    f = jax_step(jspec, 1.0, unique_cap=8)
    jshard, jemb, jcount = f(jshard, *jsplit(ids), jnp.int32(0))
    temb, ctx = torch_step(tspec, tshard, ids, 0, 1.0, unique_cap=8)
    assert int(ctx.count) == int(jcount) == 8
    np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), **TOL)
    assert_tables_match(jspec, jshard, tshard)
