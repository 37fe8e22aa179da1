"""A JAX Trainer's checkpoint resumes in the port's Trainer: the table
(restored exactly, as `test_torch_checkpoint.py` holds), the tower's params
and its dense Adam state (moments and step) carry over, so one more step on
each side gives the same loss, logits and state, with the tolerances of
`_torch_train_parity.py`: integer planes and counters exactly, floats within
rtol 1e-5 / atol 1e-6."""

import jax
import numpy as np
import torch
from _torch_train_parity import TOL, assert_tables_match, configs, jax_step

from meepoembedding_tpu.data.synthetic import SyntheticConfig, SyntheticStream
from meepoembedding_tpu.train import Trainer as JTrainer
from meepoembedding_tpu_torch.train import Trainer

torch.set_num_threads(1)


def test_trainer_resumes_a_jax_checkpoint(tmp_path):
    (jrc, jtc, jmc), (rc, tc, mc), data = configs(16, 1, "rowwise_adagrad", {}, steps=4)
    jt = JTrainer(jrc, jtc, jmc)
    batches = list(SyntheticStream(SyntheticConfig(**data)).batches(3))
    for b in batches[:2]:
        jax_step(jt, b)
    path = str(tmp_path / "ck")
    jt.save_checkpoint(path)

    tt = Trainer(rc, tc, mc, device="cpu", generator=torch.Generator().manual_seed(99))
    manifest = tt.load_checkpoint(path)
    assert manifest["step"] == tt.step == 2
    assert_tables_match(jt.spec, jt.shard, tt.shard)
    m, v, t = tt.opt_state
    jm, jv, jstep = jt.opt_state
    assert t == int(jstep) == 2
    for mine, ref in ((m, jm), (v, jv)):
        for got, want in zip(mine, jax.tree_util.tree_leaves(ref)):
            want = np.asarray(want)
            np.testing.assert_array_equal(got.numpy(), want.T if want.ndim == 2 else want)

    jloss, jlogits = jax_step(jt, batches[2])
    tloss = tt.train_step(batches[2])["loss"]
    np.testing.assert_allclose(tloss, jloss, **TOL)
    np.testing.assert_allclose(tt.last_logits.numpy(), jlogits, **TOL)
    assert_tables_match(jt.spec, jt.shard, tt.shard)
    for jp, tp in zip(jax.tree_util.tree_leaves(jt.params), tt.params):
        jp = np.asarray(jp)
        np.testing.assert_allclose(tp.detach().numpy(), jp.T if jp.ndim == 2 else jp, **TOL)


def test_port_checkpoint_writer_is_not_ported(tmp_path):
    """The checkpoint writer, once a NotImplementedError naming ROADMAP's
    "Checkpoint writer", is ported: a port Trainer's checkpoint restores
    into another port Trainer with the same table rows, tower and Adam
    state (`test_torch_ckpt_writer.py` holds it against the JAX package)."""
    (_, (rc, tc, mc), data) = configs(8, 1, "sgd", {})
    tt = Trainer(rc, tc, mc, device="cpu")
    for b in SyntheticStream(SyntheticConfig(**data)).batches(2):
        tt.train_step(b)
    tt.save_checkpoint(str(tmp_path / "ck"))
    t2 = Trainer(rc, tc, mc, device="cpu", generator=torch.Generator().manual_seed(5))
    assert t2.load_checkpoint(str(tmp_path / "ck"))["step"] == t2.step == 2
    assert len(t2.shard.cnt.nonzero()) == len(tt.shard.cnt.nonzero())
    for a, b in zip(t2.params, tt.params):
        assert torch.equal(a, b)
    assert t2.opt_state[2] == tt.opt_state[2] == 2
    for a, b in zip(t2.opt_state[0] + t2.opt_state[1], tt.opt_state[0] + tt.opt_state[1]):
        assert torch.equal(a, b)
