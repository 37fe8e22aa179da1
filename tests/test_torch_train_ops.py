"""Parity of the port's training ops with the JAX reference, on the CPU.

- `hashing.default_rows`: uniform and constant bit-exact; normal and
  truncated_normal within rtol 1e-5 / atol 1e-6 (`torch.special.erfinv`
  against JAX's; the uniform draws under them are the same bits).
- `table_ops.cms_admit`: sketch and admit mask exact.
- `table_ops.lookup_train` over a sequence of batches that fills a
  64-bucket table past 0.8 load with `max_probe_rounds=2` (so pair-overflow
  drops occur), with and without score upkeep (CMS admission + LFU): slots,
  found, fresh, the counters and the key/freq/last/cnt/ovf/cms planes
  exact, and the rows read (found rows, fresh inits) exact.
- `dedup.segment_sum_grads`: within rtol 1e-6 / atol 1e-6 (sums of a few
  f32 terms, in input order in both).
- `optim.apply_sparse_grads` for every optimizer kind, twice on one table:
  values and optimizer state within rtol 1e-5 / atol 1e-6 (rsqrt, sqrt
  and the reference's 128-lane accumulator sum round differently). The
  reference packs values 128 // dim to a storage row; reshaped to
  [capacity, dim] its plane is the port's row-major one.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meepoembedding_tpu.config import OptimizerConfig as JOptimizerConfig
from meepoembedding_tpu.config import PolicyConfig as JPolicyConfig
from meepoembedding_tpu.config import TableConfig as JTableConfig
from meepoembedding_tpu.ops import dedup as jdedup
from meepoembedding_tpu.ops import optim as joptim
from meepoembedding_tpu.table import hashing as jh
from meepoembedding_tpu.table import layout as jl
from meepoembedding_tpu.table import xla_ops as jx
from meepoembedding_tpu_torch.config import OptimizerConfig, PolicyConfig, RunConfig, TableConfig
from meepoembedding_tpu_torch.ops import dedup, optim
from meepoembedding_tpu_torch.table import hashing as th
from meepoembedding_tpu_torch.table import layout as tl
from meepoembedding_tpu_torch.table import table_ops as tx

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
NB, BATCH = 64, 2048


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("kind", th.INITIALIZERS)
@pytest.mark.parametrize("dim", [8, 32, 256])
def test_default_rows_matches(kind, dim):
    rng = np.random.default_rng(dim)
    hi, lo = jh.split_ids(rng.integers(-(2**63), 2**63 - 1, size=500, dtype=np.int64))
    want = np.asarray(jh.default_rows(jnp.asarray(hi), jnp.asarray(lo), dim, 0.05, kind=kind))
    got = th.default_rows(_t(hi), _t(lo), dim, 0.05, kind=kind).numpy()
    if kind in ("uniform", "constant"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)
    assert th.default_rows(_t(hi), _t(lo), dim, 0.0, kind=kind).abs().sum() == 0


def test_default_rows_bf16_is_the_f32_init_rounded():
    hi, lo = jh.split_ids(np.arange(1, 200, dtype=np.int64))
    want = np.asarray(jh.default_rows(jnp.asarray(hi), jnp.asarray(lo), 16, 0.05,
                                      dtype=jnp.bfloat16)).astype(np.float32)
    got = th.default_rows(_t(hi), _t(lo), 16, 0.05, dtype=torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_cms_admit_matches():
    pol = dict(admit_threshold=3, cms_width=128)  # narrow: columns collide
    jspec = jl.TableSpec.from_config(JTableConfig(capacity=NB * 128,
                                                  policy=JPolicyConfig(**pol)))
    tspec = tl.TableSpec.from_config(TableConfig(capacity=NB * 128, policy=PolicyConfig(**pol)))
    jcms = jnp.zeros((4, 128), jnp.int32)
    tcms = torch.zeros((4, 128), dtype=torch.int32)
    rng = np.random.default_rng(0)
    pool = rng.integers(1, 2**62, size=300, dtype=np.int64)
    for _ in range(4):
        hi, lo = jh.split_ids(rng.choice(pool, size=400))
        miss = rng.random(400) < 0.7
        jcms, jadmit = jx.cms_admit(jspec, jcms, jnp.asarray(hi), jnp.asarray(lo),
                                    jnp.asarray(miss))
        tadmit = tx.cms_admit(tspec, tcms, _t(hi), _t(lo), _t(miss))
        np.testing.assert_array_equal(tcms.numpy(), np.asarray(jcms))
        np.testing.assert_array_equal(tadmit.numpy(), np.asarray(jadmit))
    assert 0 < int(tadmit.sum()) < int(_t(miss).sum())


@functools.partial(jax.jit, static_argnums=(0,), donate_argnums=(1,))
def _jax_lookup_train(spec, shard, uh, ul, valid, step):
    shard, ctx = jx.lookup_train(spec, shard, uh, ul, valid, step)
    rows = jx.window_extract(spec, ctx.g128, ctx.sub)
    # as the trainer's update would: the fresh rows' inits land in the table
    values = jx.scatter_add_values(spec, shard.values, ctx.slot, rows, ctx.fresh)
    return shard._replace(values=values), ctx.slot, ctx.found, ctx.fresh, rows


@pytest.mark.parametrize("scores", [False, True], ids=["plain", "admit+lfu"])
def test_lookup_train_sequence_matches(scores):
    pol = dict(admit_threshold=2, evict_policy="lfu", cms_width=256) if scores else {}
    cfg = dict(dim=8, capacity=NB * 128, max_probe_rounds=2)
    jspec = jl.TableSpec.from_config(JTableConfig(**cfg, policy=JPolicyConfig(**pol)))
    tspec = tl.TableSpec.from_config(TableConfig(**cfg, policy=PolicyConfig(**pol)))
    assert tspec.policy.needs_scores == scores
    jshard, tshard = jl.alloc_shard(jspec), tl.alloc_shard(tspec, "cpu")
    rng = np.random.default_rng(int(scores))
    seen = np.zeros((0,), np.int64)
    for step in range(5):
        new = rng.integers(-(2**63), 2**63 - 1, size=1700, dtype=np.int64)
        old = rng.choice(seen, size=min(300, len(seen)), replace=False)
        pad = np.full(BATCH - len(new) - len(old), jh.EMPTY_ID, np.int64)
        ids = rng.permutation(np.concatenate([new, old, pad]))
        seen = np.concatenate([seen, new])
        hi, lo = jh.split_ids(ids)
        u = jdedup.unique_pairs(jnp.asarray(hi), jnp.asarray(lo), BATCH)
        jshard, jslot, jfound, jfresh, jrows = _jax_lookup_train(
            jspec, jshard, u.hi, u.lo, u.valid, jnp.int32(step))
        uh, ul, valid = (_t(x) for x in (u.hi, u.lo, u.valid))
        ctx = tx.lookup_train(tspec, tshard, uh, ul, valid, step)
        tx.scatter_add_values(tshard.values, ctx.slot, ctx.rows_u, ctx.fresh)
        for name, got, want in (("slot", ctx.slot, jslot), ("found", ctx.found, jfound),
                                ("fresh", ctx.fresh, jfresh), ("rows", ctx.rows_u, jrows)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"{name}, step {step}")
    for name in ("key_hi", "key_lo", "cnt", "ovf", "freq", "last", "counters", "cms"):
        np.testing.assert_array_equal(getattr(tshard, name).numpy(),
                                      np.asarray(getattr(jshard, name)), err_msg=name)
    c = tshard.counters.numpy()
    assert c[tl.DROPS] > 0, "the sequence must overflow some bucket pairs"
    assert (c[tl.DENIED] > 0) == scores
    assert tshard.cnt.sum() > 0.8 * tspec.capacity


def test_segment_sum_grads_matches():
    rng = np.random.default_rng(4)
    n, U, dim = 3000, 700, 32
    inverse = rng.integers(0, U, size=n).astype(np.int32)
    grads = rng.normal(size=(n, dim)).astype(np.float32)
    want = np.asarray(jdedup.segment_sum_grads(jnp.asarray(grads), jnp.asarray(inverse), U))
    got = dedup.segment_sum_grads(_t(grads), _t(inverse), U)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_gather_rows_backward_is_the_segment_sum():
    rng = np.random.default_rng(6)
    rows = torch.from_numpy(rng.normal(size=(50, 8)).astype(np.float32)).requires_grad_(True)
    inverse = _t(rng.integers(0, 50, size=400).astype(np.int32))
    w = torch.from_numpy(rng.normal(size=(400, 8)).astype(np.float32))
    out = dedup.GatherRows.apply(rows, inverse)
    assert torch.equal(out, rows.detach()[inverse.long()])
    (out * w).sum().backward()
    want = torch.zeros(50, 8).index_add_(0, inverse.long(), w)
    assert torch.equal(rows.grad, want)


KINDS = ("sgd", "momentum", "rowwise_adagrad", "adagrad", "adam", "ftrl")


@pytest.mark.parametrize("kind", KINDS)
def test_apply_sparse_grads_matches(kind):
    opt = dict(kind=kind, learning_rate=0.1, l1=0.01, l2=0.1)
    cfg = dict(dim=16, capacity=NB * 128, max_probe_rounds=2)
    jspec = jl.TableSpec.from_config(JTableConfig(**cfg, optimizer=JOptimizerConfig(**opt)))
    tspec = tl.TableSpec.from_config(TableConfig(**cfg, optimizer=OptimizerConfig(**opt)))
    rng = np.random.default_rng(KINDS.index(kind))
    ids = rng.integers(1, 2**62, size=1024, dtype=np.int64)
    hi, lo = jh.split_ids(ids)
    rows = rng.normal(size=(1024, 16)).astype(np.float32) * 0.1
    valid = np.ones(1024, bool)
    tshard = tl.alloc_shard(tspec, "cpu")
    tx.insert_rows(tspec, tshard, _t(hi), _t(lo), _t(rows), _t(valid), 0)
    # the same state in the reference's layout (its insert is held exactly
    # against the port's by test_torch_table_ops.py), copied: a jax array
    # made from a numpy view may share the buffer the port updates in place
    C = tspec.capacity

    def jcopy(t, shape=None):
        a = t.numpy().copy()
        return jnp.asarray(a if shape is None else a.reshape(shape))

    jshard = jl.alloc_shard(jspec)
    jshard = jshard._replace(
        **{k: jcopy(getattr(tshard, k)) for k in ("key_hi", "key_lo", "cnt", "ovf", "freq",
                                                  "last")},
        values=jcopy(tshard.values, jshard.values.shape),
        opt_rowwise=tuple(jcopy(p) for p in tshard.opt_rowwise),
        opt_fulldim=tuple(jcopy(p, jp.shape)
                          for p, jp in zip(tshard.opt_fulldim, jshard.opt_fulldim)))
    pr = tx.probe(tspec, tshard, _t(hi), _t(lo), _t(valid))
    slot = torch.where(pr.found, pr.slot, -1)
    slot[::9] = -1  # denied / dropped ids update nothing
    for _ in range(2):
        grad = rng.normal(size=(1024, 16)).astype(np.float32)
        jshard = joptim.apply_sparse_grads(jspec, jshard, jcopy(slot), jnp.asarray(grad))
        optim.apply_sparse_grads(tspec, tshard, slot, _t(grad))
    np.testing.assert_allclose(tshard.values.numpy(),
                               np.asarray(jshard.values).reshape(C, 16), **TOL)
    for tp, jp in zip(tshard.opt_fulldim, jshard.opt_fulldim):
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp).reshape(C, 16), **TOL)
    for tp, jp in zip(tshard.opt_rowwise, jshard.opt_rowwise):
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    skipped = pr.slot.numpy()[::9]
    np.testing.assert_array_equal(tshard.values.numpy()[skipped], rows[::9])


def test_streaming_auc_matches():
    from meepoembedding_tpu.metrics import StreamingAUC as JStreamingAUC
    from meepoembedding_tpu_torch.metrics import StreamingAUC

    rng = np.random.default_rng(9)
    jauc, tauc = JStreamingAUC(num_bins=512), StreamingAUC(num_bins=512)
    for _ in range(3):
        labels = (rng.random(300) < 0.3).astype(np.float32)
        logits = (rng.normal(size=300) + labels).astype(np.float32)
        jauc.update(jnp.asarray(logits), jnp.asarray(labels))
        tauc.update(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_array_equal(tauc.pos.numpy(), jauc.pos)
    np.testing.assert_array_equal(tauc.neg.numpy(), jauc.neg)
    assert tauc.compute() == jauc.compute() > 0.5


def test_dense_optimizers_match():
    """dense_sgd_update, dense_adam_update (two steps), clip_by_global_norm
    and schedule_lr against the reference on the same pytree of leaves."""
    rng = np.random.default_rng(12)
    shapes = [(5, 3), (3,), (4, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jp, jg = [jnp.asarray(p) for p in params], [jnp.asarray(g) for g in grads]

    jclip = joptim.clip_by_global_norm(jg, 0.7)
    tclip = optim.clip_by_global_norm([_t(g) for g in grads], 0.7)
    for a, b in zip(tclip, jclip):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)

    tp = [_t(p) for p in params]
    optim.dense_sgd_update(tp, [_t(g) for g in grads], optim.dense_sgd_init(tp), 0.1)
    jnew, _ = joptim.dense_sgd_update(jp, jg, joptim.dense_sgd_init(jp), 0.1)
    for a, b in zip(tp, jnew):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)

    tp = [_t(p) for p in params]
    tstate, jstate, jnew = optim.dense_adam_init(tp), joptim.dense_adam_init(jp), jp
    for lr in (1e-2, 3e-3):
        tstate = optim.dense_adam_update(tp, [_t(g) for g in grads], tstate, lr)
        jnew, jstate = joptim.dense_adam_update(jnew, jg, jstate, lr)
    for a, b in zip(tp, jnew):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert tstate[2] == int(jstate[2]) == 2

    for kind in ("constant", "linear", "cosine"):
        for step in (0, 3, 7, 12):
            want = float(joptim.schedule_lr(kind, 0.01, step, 10, warmup_steps=4))
            np.testing.assert_allclose(optim.schedule_lr(kind, 0.01, step, 10, 4), want,
                                       rtol=1e-6)


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
@pytest.mark.parametrize("clip", [None, 0.7])
def test_dense_step_matches(clip, schedule):
    """`optim.dense_step` at `optim.scheduled_lr`, three steps, against the
    reference's clip, schedule and Adam as its trainers chain them."""
    rc = RunConfig(steps=6, warmup_steps=2 if schedule != "constant" else 0,
                   dense_learning_rate=0.05, lr_schedule=schedule, grad_clip_norm=clip)
    rng = np.random.default_rng(13)
    shapes = [(5, 3), (3,), (4, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    tp, jp = [_t(p) for p in params], [jnp.asarray(p) for p in params]
    tstate, jstate = optim.dense_adam_init(tp), joptim.dense_adam_init(jp)
    for step in range(3):
        grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
        lr = optim.scheduled_lr(rc, step)
        want_lr = float(joptim.schedule_lr(schedule, 0.05, step, 6, rc.warmup_steps))
        np.testing.assert_allclose(lr, want_lr, rtol=1e-6)
        tstate = optim.dense_step(rc, tp, [_t(g) for g in grads], tstate, lr)
        jg = [jnp.asarray(g) for g in grads]
        if clip is not None:
            jg = joptim.clip_by_global_norm(jg, clip)
        jp, jstate = joptim.dense_adam_update(jp, jg, jstate, want_lr)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    for a, b in zip(tstate[:2], jstate[:2]):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL)
    assert tstate[2] == int(jstate[2]) == 3
