"""The port's static hash-trick baseline (`baseline.StaticEmbeddingTrainer`)
against the JAX package's, from one carried state (table, accumulator,
tower): 3 steps with equal loss and logits, table and accumulator within
rtol 1e-5 / atol 1e-6 (the duplicate-summed table gradient adds in another
order), rows no id touched bit for bit, and the same eval."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_train_parity import TOL

from meepoembedding_tpu.baseline import StaticEmbeddingTrainer as JStatic
from meepoembedding_tpu.config import ModelConfig as JModelConfig
from meepoembedding_tpu.config import RunConfig as JRunConfig
from meepoembedding_tpu.table import hashing as jh
from meepoembedding_tpu_torch.baseline import StaticEmbeddingTrainer
from meepoembedding_tpu_torch.config import ModelConfig, RunConfig
from meepoembedding_tpu_torch.data import SyntheticConfig, SyntheticStream
from meepoembedding_tpu_torch.weights import from_jax_params, to_jax_params

torch.set_num_threads(1)

MODEL = dict(num_dense_features=4, num_sparse_features=4, embedding_dim=16,
             bottom_mlp=(32, 16), top_mlp=(32, 1))
VOCAB = 1 << 10


def _jax_step(jst, batch):
    hi, lo = jh.split_ids(batch["ids"])
    (jst.table, jst.accum, jst.params, jst.opt_state, loss, logits) = jst._step_fn(
        jst.table, jst.accum, jst.params, jst.opt_state, jnp.asarray(batch["dense"]),
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(batch["label"]))
    return float(loss), np.asarray(logits)


@pytest.mark.parametrize("kind", ["dlrm", "deepfm"])
def test_static_baseline_matches_jax(kind):
    run = dict(batch_size=64, seed=3, dense_learning_rate=1e-3)
    jst = JStatic(JRunConfig(**run), JModelConfig(kind=kind, **MODEL), VOCAB, table_lr=0.05)
    st = StaticEmbeddingTrainer(RunConfig(**run), ModelConfig(kind=kind, **MODEL), VOCAB,
                                table_lr=0.05, device="cpu")
    st.table = torch.from_numpy(np.array(jst.table))
    st.accum = torch.from_numpy(np.array(jst.accum))
    from_jax_params(st.model, jax.tree_util.tree_map(np.asarray, jst.params))
    table0 = st.table.clone()
    batches = list(SyntheticStream(SyntheticConfig(num_dense=4, num_sparse=4, batch_size=64,
                                                   vocab_per_feature=300, seed=1)).batches(4))
    touched = np.zeros(VOCAB, bool)
    for step, b in enumerate(batches[:3]):
        jloss, jlogits = _jax_step(jst, b)
        tloss = st.train_step(b)["loss"]
        np.testing.assert_allclose(tloss, jloss, **TOL, err_msg=f"loss, step {step}")
        hi, lo = jh.split_ids(b["ids"].reshape(-1))
        touched[np.asarray(jh.hash_pair(jnp.asarray(hi), jnp.asarray(lo), jh.SALT_BUCKET))
                % VOCAB] = True
    assert st.step == 3 and 0 < touched.sum() < VOCAB
    np.testing.assert_allclose(st.table.numpy(), np.asarray(jst.table), **TOL)
    np.testing.assert_allclose(st.accum.numpy(), np.asarray(jst.accum), **TOL)
    np.testing.assert_array_equal(st.table[~touched].numpy(), table0[~touched].numpy())
    assert np.all(st.accum[~touched].numpy() == np.float32(0.1))
    for mine, ref in zip(to_jax_params(st.model), jax.tree_util.tree_leaves(jst.params)):
        np.testing.assert_allclose(mine, np.asarray(ref), **TOL)
    jev, tev = jst.eval_step(batches[3]), st.eval_step(batches[3])
    np.testing.assert_allclose(tev["loss"], jev["loss"], **TOL)
    np.testing.assert_allclose(tev["logits"].numpy(), np.asarray(jev["logits"]), **TOL)


def test_static_baseline_refuses_other_vocab_sizes():
    with pytest.raises(ValueError, match="power of two"):
        StaticEmbeddingTrainer(RunConfig(), ModelConfig(**MODEL), 1000, device="cpu")
