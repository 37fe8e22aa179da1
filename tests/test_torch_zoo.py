"""The port's model zoo against the JAX package's, from carried params:

- every kind's forward, one-hot and (DIN, BST) on bags that include
  all-padding bags, within rtol 1e-5 / atol 1e-6; the param leaves round
  trip exactly;
- the two-tower's item key, the host item keys and the count-min
  estimator's log q exactly, and its in-batch softmax loss and margins with
  accidental hits and log q within the tolerance;
- 3 Trainer steps a kind from one state (`_torch_train_parity.py`, one
  case a kind; two-tower with logQ on);
- a JAX DCN and a JAX BST checkpoint restore into the port's Trainer and
  ScoringService with equal scores, and the port's save restores into JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_train_parity import TOL, assert_params_match, configs, jax_step, run_trainer_case

from meepoembedding_tpu.config import ModelConfig as JModelConfig
from meepoembedding_tpu.data.synthetic import SyntheticConfig as JSyntheticConfig
from meepoembedding_tpu.data.synthetic import SyntheticStream as JSyntheticStream
from meepoembedding_tpu.models import build_model as jbuild_model
from meepoembedding_tpu.models.common import model_apply as jmodel_apply
from meepoembedding_tpu.models.common import model_loss as jmodel_loss
from meepoembedding_tpu.ops import itemfreq as jitemfreq
from meepoembedding_tpu.table import hashing as jh
from meepoembedding_tpu.train import Trainer as JTrainer
from meepoembedding_tpu_torch.config import ModelConfig
from meepoembedding_tpu_torch.models import KINDS, build_model
from meepoembedding_tpu_torch.models.common import model_apply, model_loss
from meepoembedding_tpu_torch.ops import itemfreq
from meepoembedding_tpu_torch.serving import ScoringService
from meepoembedding_tpu_torch.table import hashing
from meepoembedding_tpu_torch.train import Trainer
from meepoembedding_tpu_torch.weights import from_jax_params, to_jax_params

torch.set_num_threads(1)

MODEL = dict(num_dense_features=4, num_sparse_features=4, embedding_dim=16,
             bottom_mlp=(32, 16), top_mlp=(32, 1), num_cross_layers=2, attention_heads=2,
             transformer_blocks=2, max_seq_len=8)
B, L = 64, 5


def _pair(kind, seed=0):
    jm = jbuild_model(JModelConfig(kind=kind, **MODEL))
    params = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(ModelConfig(kind=kind, **MODEL))
    from_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


def _bag_valid(rng):
    valid = rng.random((B, 4, L)) < 0.7
    valid[:6, 0] = False  # no target
    valid[6:12, 1] = False  # an empty behaviour sequence
    valid[12:16] = False  # every bag empty
    return valid


def test_build_model_covers_every_kind():
    assert set(KINDS) == {"dlrm", "ctr_mlp", "dcn", "deepfm", "two_tower", "din", "bst"}
    for kind in KINDS:
        assert type(build_model(ModelConfig(kind=kind, **MODEL))).__name__ == type(
            jbuild_model(JModelConfig(kind=kind, **MODEL))).__name__
    with pytest.raises(ValueError, match="unknown model kind"):
        build_model(ModelConfig(kind="nope", **MODEL))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_forward_matches_jax(kind):
    jm, params, tm = _pair(kind, seed=len(kind))
    rng = np.random.default_rng(len(kind))
    dense = rng.normal(size=(B, 4)).astype(np.float32)
    emb = rng.normal(size=(B, 4, 16)).astype(np.float32) * 0.1
    want = np.asarray(jmodel_apply(jm, params, jnp.asarray(dense), jnp.asarray(emb)))
    with torch.no_grad():
        got = model_apply(tm, torch.from_numpy(dense), torch.from_numpy(emb)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    for mine, ref in zip(to_jax_params(tm), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(mine, np.asarray(ref))


@pytest.mark.parametrize("kind", ["din", "bst"])
def test_bag_forward_matches_jax_with_empty_bags(kind):
    jm, params, tm = _pair(kind, seed=3)
    rng = np.random.default_rng(4)
    dense = rng.normal(size=(B, 4)).astype(np.float32)
    emb = rng.normal(size=(B, 4, L, 16)).astype(np.float32) * 0.1
    valid = _bag_valid(rng)
    emb[~valid] = 0.0  # padded lanes gather zero rows, as in the trainers
    want = np.asarray(jmodel_apply(jm, params, jnp.asarray(dense), jnp.asarray(emb),
                                   jnp.asarray(valid)))
    with torch.no_grad():
        got = model_apply(tm, torch.from_numpy(dense), torch.from_numpy(emb),
                          torch.from_numpy(valid)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def _ids(rng, bags: bool):
    shape = (B, 4, L) if bags else (B, 4)
    ids = (np.arange(4, dtype=np.int64).reshape((1, 4) + (1,) * bags) << 44) | rng.integers(
        0, 30, size=shape)
    ids[1::7] = ids[0]  # rows carrying the same item
    if bags:
        ids[rng.random(shape) < 0.3] = jh.EMPTY_ID
        ids[12:16, 1:] = jh.EMPTY_ID
    return ids


@pytest.mark.parametrize("bags", [False, True], ids=["one-hot", "bags"])
def test_item_keys_are_bit_exact(bags):
    rng = np.random.default_rng(9 + bags)
    ids = _ids(rng, bags)
    jm, _, tm = _pair("two_tower")
    hi, lo = jh.split_ids(ids)
    want = np.asarray(jm.item_key(jnp.asarray(hi), jnp.asarray(lo)))
    got = tm.item_key(*hashing.split_ids_t(torch.from_numpy(ids)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(itemfreq.item_keys_np(ids, 1), jitemfreq.item_keys_np(ids, 1))
    np.testing.assert_array_equal(itemfreq._mix64(ids.view(np.uint64)),
                                  jitemfreq._mix64(ids.view(np.uint64)))


def test_frequency_estimator_is_bit_exact():
    rng = np.random.default_rng(2)
    mine, ref = itemfreq.ItemFrequencyEstimator(1 << 10, 3), jitemfreq.ItemFrequencyEstimator(
        1 << 10, 3)
    for _ in range(5):
        keys = itemfreq.item_keys_np(_ids(rng, False), 1)
        np.testing.assert_array_equal(mine.update_and_logq(keys), ref.update_and_logq(keys))
    np.testing.assert_array_equal(mine.counts, ref.counts)
    assert mine.batches == ref.batches == 5
    with pytest.raises(ValueError):
        itemfreq.ItemFrequencyEstimator(1000)


def test_two_tower_loss_matches_jax():
    jm, params, tm = _pair("two_tower", seed=5)
    rng = np.random.default_rng(6)
    ids = _ids(rng, False)
    dense = rng.normal(size=(B, 4)).astype(np.float32)
    emb = rng.normal(size=(B, 4, 16)).astype(np.float32) * 0.1
    label = (rng.random(B) < 0.6).astype(np.float32)
    logq = jitemfreq.ItemFrequencyEstimator().update_and_logq(jitemfreq.item_keys_np(ids, 1))
    hi, lo = jh.split_ids(ids)
    jkey = jm.item_key(jnp.asarray(hi), jnp.asarray(lo))
    tkey = tm.item_key(*hashing.split_ids_t(torch.from_numpy(ids)))
    for q in (None, logq):
        jloss, jmargin = jmodel_loss(jm, params, jnp.asarray(dense), jnp.asarray(emb), None,
                                     jnp.asarray(label), jkey,
                                     logq=None if q is None else jnp.asarray(q))
        with torch.no_grad():
            tloss, tmargin = model_loss(tm, torch.from_numpy(dense), torch.from_numpy(emb),
                                        None, torch.from_numpy(label), tkey,
                                        logq=None if q is None else torch.from_numpy(q))
        np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
        np.testing.assert_allclose(tmargin.numpy(), np.asarray(jmargin), **TOL)


CASES = [("ctr_mlp", 1), ("dcn", 1), ("deepfm", 1), ("din", 4), ("bst", 4), ("two_tower", 3)]


@pytest.mark.parametrize("kind,bag", CASES, ids=[k for k, _ in CASES])
def test_trainer_matches_jax(kind, bag):
    """3 steps from one state; two-tower with logQ on, on bags (the item
    key's bag path)."""
    run_trainer_case(16, bag, "rowwise_adagrad", {}, check_eval=True, model_kind=kind,
                     nsparse=4, batch=64)


def test_logq_needs_a_retrieval_model():
    (_, (rc, tc, mc), _) = configs(16, 1, "rowwise_adagrad", {}, model_kind="dlrm")
    with pytest.raises(ValueError, match="logq_correction needs a retrieval model"):
        Trainer(rc, tc, ModelConfig(**{**mc.__dict__, "logq_correction": True}), device="cpu")


@pytest.mark.parametrize("kind,bag", [("dcn", 1), ("bst", 4)])
def test_checkpoints_cross_both_ways(tmp_path, kind, bag):
    (jrc, jtc, jmc), (rc, tc, mc), data = configs(16, bag, "rowwise_adagrad", {},
                                                  model_kind=kind, nsparse=4, batch=64)
    batches = list(JSyntheticStream(JSyntheticConfig(**data)).batches(4))
    jt = JTrainer(jrc, jtc, jmc)
    for b in batches[:2]:
        jax_step(jt, b)
    jt.save_checkpoint(str(tmp_path / "jax"))

    tt = Trainer(rc, tc, mc, device="cpu", generator=torch.Generator().manual_seed(7))
    assert tt.load_checkpoint(str(tmp_path / "jax"))["step"] == 2
    assert_params_match(jt, tt)
    jev, tev = jt.eval_step(batches[2]), tt.eval_step(batches[2])
    np.testing.assert_allclose(tev["logits"].numpy(), np.asarray(jev["logits"]), **TOL)
    svc = ScoringService(str(tmp_path / "jax"), tc, mc, device="cpu")
    np.testing.assert_allclose(svc.score(batches[2]["dense"], batches[2]["ids"]),
                               torch.sigmoid(tev["logits"]).numpy(), **TOL)

    jloss, _ = jax_step(jt, batches[2])
    np.testing.assert_allclose(tt.train_step(batches[2])["loss"], jloss, **TOL)
    tt.save_checkpoint(str(tmp_path / "port"))
    back = JTrainer(jrc, jtc, jmc)
    assert back.load_checkpoint(str(tmp_path / "port"))["step"] == 3
    assert_params_match(back, tt)
    jev, tev = back.eval_step(batches[3]), tt.eval_step(batches[3])
    np.testing.assert_allclose(np.asarray(jev["logits"]), tev["logits"].numpy(), **TOL)
    for a, b in zip(jax.tree_util.tree_leaves(back.opt_state), jax.tree_util.tree_leaves(
            jt.opt_state)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)
