"""Shared by the port's Trainer, model-zoo and lifecycle tests: one training
case (of any model kind) run through the port's Trainer and the JAX
package's from one state, with
everything compared after every step and at the end; and the converters
that carry a table shard between the two packages bit for bit
(`numpy_planes`, `to_torch_shard`, `to_jax_shard`).

Exact: key, freq, last, cnt and ovf planes and the counters (so every slot,
insert and drop). Within rtol 1e-5 / atol 1e-6: loss, logits, values,
optimizer state and dense params. The towers' f32 matmuls and the segment
sums run in another order in PyTorch than in XLA, and the reference's
rowwise accumulator sums g^2 over 128 window lanes where the port sums
over dim lanes."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

from meepoembedding_tpu.config import ModelConfig as JModelConfig
from meepoembedding_tpu.config import OptimizerConfig as JOptimizerConfig
from meepoembedding_tpu.config import RunConfig as JRunConfig
from meepoembedding_tpu.config import TableConfig as JTableConfig
from meepoembedding_tpu.data.synthetic import SyntheticConfig as JSyntheticConfig
from meepoembedding_tpu.data.synthetic import SyntheticStream as JSyntheticStream
from meepoembedding_tpu.table import hashing as jh
from meepoembedding_tpu.table import xla_ops as jx
from meepoembedding_tpu.train import Trainer as JTrainer
from meepoembedding_tpu_torch.config import ModelConfig, OptimizerConfig, RunConfig, TableConfig
from meepoembedding_tpu.table import layout as jl
from meepoembedding_tpu_torch.data import SyntheticConfig, SyntheticStream
from meepoembedding_tpu_torch.table import layout as tl
from meepoembedding_tpu_torch.train import Trainer
from meepoembedding_tpu_torch.weights import from_jax_params, to_jax_params

TOL = dict(rtol=1e-5, atol=1e-6)
INT_PLANES = ("key_hi", "key_lo", "freq", "last", "cnt", "ovf", "counters")


PLANES = ("key_hi", "key_lo", "cnt", "ovf", "freq", "last", "values", "counters", "cms")


def numpy_planes(shard) -> dict:
    """Host copies of a shard's planes, of either package, by name; values
    and full-dim planes as [capacity, dim] rows (the JAX package packs them
    128 // dim to a 128-lane row, which is the same bytes row-major), bf16
    as its uint16 bits."""
    def host(x):
        if isinstance(x, torch.Tensor):
            return (x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16
                    else x.numpy()).copy()
        a = np.array(x)
        return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a

    out = {name: host(getattr(shard, name)) for name in PLANES}
    out["opt_rowwise"] = [host(p) for p in shard.opt_rowwise]
    out["opt_fulldim"] = [host(p) for p in shard.opt_fulldim]
    return out


def _rows(a, dim, bf16, to_jax):
    a = a.reshape(-1, 128) if to_jax else a.reshape(-1, dim)
    if bf16:
        return a.view(ml_dtypes.bfloat16) if to_jax else torch.from_numpy(
            a.view(np.int16).copy()).view(torch.bfloat16)
    return a.copy() if to_jax else torch.from_numpy(a.copy())


def to_torch_shard(planes: dict, spec) -> "tl.TableShard":
    """The port's shard holding `planes` (from `numpy_planes`), on the CPU."""
    bf16 = spec.value_dtype == "bfloat16"
    t = {n: torch.from_numpy(planes[n].copy()) for n in PLANES if n != "values"}
    return tl.TableShard(
        values=_rows(planes["values"], spec.dim, bf16, False),
        opt_rowwise=tuple(torch.from_numpy(p.copy()) for p in planes["opt_rowwise"]),
        opt_fulldim=tuple(_rows(p, spec.dim, bf16, False) for p in planes["opt_fulldim"]),
        **t)


def to_jax_shard(planes: dict, spec) -> "jl.TableShard":
    """The JAX package's shard holding `planes` (from `numpy_planes`)."""
    bf16 = spec.value_dtype == "bfloat16"
    return jl.TableShard(
        values=jnp.asarray(_rows(planes["values"], spec.dim, bf16, True)),
        opt_rowwise=tuple(jnp.asarray(p) for p in planes["opt_rowwise"]),
        opt_fulldim=tuple(jnp.asarray(_rows(p, spec.dim, bf16, True))
                          for p in planes["opt_fulldim"]),
        **{n: jnp.asarray(planes[n]) for n in PLANES if n != "values"})


def assert_planes_equal(jshard, tshard, what=""):
    """Every plane of the two shards bit for bit."""
    a, b = numpy_planes(jshard), numpy_planes(tshard)
    for n in PLANES:
        np.testing.assert_array_equal(b[n].reshape(a[n].shape), a[n], err_msg=f"{what} {n}")
    for kind in ("opt_rowwise", "opt_fulldim"):
        assert len(a[kind]) == len(b[kind])
        for x, y in zip(a[kind], b[kind]):
            np.testing.assert_array_equal(y.reshape(x.shape), x, err_msg=f"{what} {kind}")


def configs(dim, bag, kind, run_opts, steps=3, model_kind="dlrm", nsparse=3, batch=96):
    """(JAX configs, port configs, SyntheticConfig fields) of one case; a
    two_tower model trains with logQ correction."""
    table = dict(dim=dim, capacity=2048, max_probe_rounds=2)
    model = dict(kind=model_kind, num_dense_features=4, num_sparse_features=nsparse,
                 embedding_dim=dim, bottom_mlp=(16, dim), top_mlp=(16, 1),
                 logq_correction=model_kind == "two_tower")
    run = dict(batch_size=batch, steps=steps, seed=dim + bag, dense_learning_rate=1e-3,
               **run_opts)
    jcfg = (JRunConfig(**run), JTableConfig(**table, optimizer=JOptimizerConfig(kind=kind)),
            JModelConfig(**model))
    tcfg = (RunConfig(**run), TableConfig(**table, optimizer=OptimizerConfig(kind=kind)),
            ModelConfig(**model))
    data = dict(num_dense=4, num_sparse=nsparse, batch_size=batch, vocab_per_feature=400,
                seed=bag, bag_len=bag)
    return jcfg, tcfg, data


def jax_step(jt, batch):
    """`JTrainer.train_step` (log q included), keeping the logits it feeds
    to its AUC."""
    hi, lo = jh.split_ids(batch["ids"])
    logq = None
    if jt._freq_est is not None:
        from meepoembedding_tpu.ops.itemfreq import item_keys_np

        logq = jnp.asarray(jt._freq_est.update_and_logq(item_keys_np(batch["ids"], jt.model.qf)))
    jt.shard, jt.params, jt.opt_state, loss, logits = jt._step_fn(
        jt.shard, jt.params, jt.opt_state, jnp.asarray(batch["dense"]), jnp.asarray(hi),
        jnp.asarray(lo), jnp.asarray(batch["label"]), jnp.int32(jt.step), logq)
    jt.step += 1
    return float(loss), np.asarray(logits)


def assert_tables_match(jspec, jshard, tshard):
    for name in INT_PLANES:
        np.testing.assert_array_equal(getattr(tshard, name).numpy(),
                                      np.asarray(getattr(jshard, name)), err_msg=name)
    slots = jnp.arange(jspec.capacity, dtype=jnp.int32)
    np.testing.assert_allclose(tshard.values.numpy(),
                               np.asarray(jx.gather_values(jspec, jshard.values, slots)),
                               **TOL, err_msg="values")
    for j, (tp, jp) in enumerate(zip(tshard.opt_fulldim, jshard.opt_fulldim)):
        np.testing.assert_allclose(tp.numpy(), np.asarray(jx.gather_values(jspec, jp, slots)),
                                   **TOL, err_msg=f"fulldim {j}")
    for tp, jp in zip(tshard.opt_rowwise, jshard.opt_rowwise):
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL, err_msg="accum")


def zero_grad_leaves(mc) -> set:
    """Leaves whose gradient is 0 in exact arithmetic: DIN's last attention
    bias adds one constant to every logit of a softmax, which the softmax
    ignores. Both packages move it by rounding noise, which Adam's
    normalisation scales up to ~1e-5 a step; it reaches no output, and the
    loss and logits, which hold the rest of the tower, are compared."""
    return {2 * len(mc.attention_mlp) + 1} if mc.kind == "din" else set()


def logits_tol(tt) -> dict:
    """TOL, but for the two-tower's margins: a margin is the difference of
    two scores of magnitude up to tau = exp(log_tau) (~10), so its rounding
    error scales with tau, not with the margin; its atol is rtol * tau."""
    if tt.model_cfg.kind != "two_tower":
        return TOL
    tau = float(torch.exp(tt.model.log_tau.detach()))
    return dict(rtol=TOL["rtol"], atol=TOL["rtol"] * tau)


def assert_params_match(jt, tt):
    """The two trainers' dense params, leaf for leaf in the reference's
    order, within TOL (but `zero_grad_leaves`)."""
    jleaves = jax.tree_util.tree_leaves(jt.params)
    tleaves = to_jax_params(tt.model)
    assert len(jleaves) == len(tleaves)
    skip = zero_grad_leaves(tt.model_cfg)
    for j, (jp, tp) in enumerate(zip(jleaves, tleaves)):
        if j not in skip:
            np.testing.assert_allclose(tp, np.asarray(jp), **TOL, err_msg=f"param leaf {j}")


def run_trainer_case(dim, bag, kind, run_opts, check_eval=False, **model):
    """`model`: configs()'s model_kind, nsparse and batch."""
    (jrc, jtc, jmc), (rc, tc, mc), data = configs(dim, bag, kind, run_opts, **model)
    jt = JTrainer(jrc, jtc, jmc)
    tt = Trainer(rc, tc, mc, device="cpu")
    from_jax_params(tt.model, jax.tree_util.tree_map(np.asarray, jt.params))
    batches = list(JSyntheticStream(JSyntheticConfig(**data)).batches(rc.steps + 1))
    mine = list(SyntheticStream(SyntheticConfig(**data)).batches(rc.steps + 1))
    for b, m in zip(batches, mine):  # the port's copy of the stream gives the same batches
        for k in b:
            np.testing.assert_array_equal(b[k], m[k])
    for step, batch in enumerate(batches[:-1]):
        jloss, jlogits = jax_step(jt, batch)
        tloss = tt.train_step(batch)["loss"]
        np.testing.assert_allclose(tloss, jloss, **TOL, err_msg=f"loss, step {step}")
        np.testing.assert_allclose(tt.last_logits.numpy(), jlogits, **logits_tol(tt),
                                   err_msg=f"logits, step {step}")
    assert_tables_match(jt.spec, jt.shard, tt.shard)
    assert tt.counters()["inserts"] > 0 and tt.counters()["hits"] > 0
    assert_params_match(jt, tt)
    if check_eval:  # probe-only eval on a batch of known and unknown ids
        jev, tev = jt.eval_step(batches[-1]), tt.eval_step(batches[-1])
        np.testing.assert_allclose(tev["loss"], jev["loss"], **TOL)
        np.testing.assert_allclose(tev["logits"].numpy(), np.asarray(jev["logits"]),
                                   **logits_tol(tt))
