"""The port's Trainer and training API against the JAX package's, on the CPU.

Both trainers start from one state: the JAX tower's params are carried into
the port's DLRM (`weights.from_jax_params`), dense Adam starts at zero, the
tables start empty, and both take the same numpy batches of the (copied)
SyntheticStream. Loss and logits are compared after every step, every plane
of the table and every dense param after the last, with the tolerances of
`_torch_train_parity.py`: integer planes and counters exactly, floats within
rtol 1e-5 / atol 1e-6.

Dims 8 and 32 take the reference's 128-lane window path, dim 256 its
`find_or_insert` path; the port has one path for all three. This file holds
one-hot [B, S] batches and the table API; `test_torch_train_bags.py` the
multi-hot mean bags. The JAX step is jitted once per case: the cases are few
and tiny so that each file stays cheap."""

import numpy as np
import pytest
import torch
from _torch_train_parity import TOL, assert_tables_match, run_trainer_case

from meepoembedding_tpu.config import TableConfig as JTableConfig
from meepoembedding_tpu.table.runtime import DynamicEmbeddingTable as JTable
from meepoembedding_tpu_torch.config import ModelConfig, PolicyConfig, RunConfig, TableConfig
from meepoembedding_tpu_torch.table.runtime import DynamicEmbeddingTable
from meepoembedding_tpu_torch.train import Trainer

torch.set_num_threads(1)

# (dim, sparse optimizer, run options)
CASES = [
    (8, "rowwise_adagrad", {}),
    (32, "sgd", dict(grad_clip_norm=0.5, lr_schedule="cosine", warmup_steps=1)),
    (256, "rowwise_adagrad", {}),
]


@pytest.mark.parametrize("dim,kind,run_opts", CASES, ids=[f"dim{d}-{k}" for d, k, _ in CASES])
def test_trainer_matches_jax(dim, kind, run_opts):
    run_trainer_case(dim, 1, kind, run_opts, check_eval=dim == 8)


@pytest.mark.parametrize("dim", [8, 256])
def test_table_train_api_matches_jax(dim):
    """lookup(train=True) writes fresh rows and accumulators at lookup;
    apply_grads applies the update without folding the init in. Rows,
    planes and state after three lookup/update rounds, with repeated ids,
    padding to a power of two and unknown ids."""
    cfg = dict(dim=dim, capacity=1024, max_probe_rounds=2)
    jt, tt = JTable(JTableConfig(**cfg)), DynamicEmbeddingTable(TableConfig(**cfg), device="cpu")
    rng = np.random.default_rng(dim)
    pool = rng.integers(1, 2**62, size=400, dtype=np.int64)
    for _ in range(3):
        ids = rng.choice(pool, size=300)  # repeats; 300 pads to 512
        jrows = np.asarray(jt.lookup(ids, train=True))
        trows = tt.lookup(ids, train=True)
        np.testing.assert_allclose(trows.numpy(), jrows, **TOL)
        grads = rng.normal(size=(300, dim)).astype(np.float32)
        jt.apply_grads(grads)
        tt.apply_grads(torch.from_numpy(grads))
    assert_tables_match(jt.spec, jt.shard, tt.shard)
    assert tt.step == jt.step == 3
    probe_ids = np.concatenate([pool[:50], rng.integers(-(2**62), -1, size=20)])
    np.testing.assert_allclose(tt.lookup(probe_ids, train=False).numpy(),
                               np.asarray(jt.lookup(probe_ids, train=False)), **TOL)


def test_unported_methods_name_their_roadmap_items():
    """The methods that raised naming ROADMAP's "Lifecycle" and "Checkpoint
    writer" items are ported now: each runs and none raises
    NotImplementedError (their parity with the JAX package is held in
    `test_torch_lifecycle.py`, `test_torch_tiering.py` and
    `test_torch_ckpt_writer.py`)."""
    import tempfile

    tc = TableConfig(dim=8, capacity=1024)
    table = DynamicEmbeddingTable(tc, device="cpu")
    table.lookup(np.arange(1, 4), train=True)
    assert table.evict() == 0  # evict_policy "none" selects nothing
    assert table.remove(np.arange(3)) == 2 and len(table) == 1
    mc = ModelConfig(num_dense_features=4, num_sparse_features=3, embedding_dim=8,
                     bottom_mlp=(16, 8), top_mlp=(16, 1))
    tr = Trainer(RunConfig(), tc, mc, device="cpu")
    assert tr.maintenance() == {"evicted": 0}
    with tempfile.TemporaryDirectory() as d:
        assert tr.save_checkpoint(d)["counts"] == [0]
    lfu = TableConfig(dim=8, capacity=1024, policy=PolicyConfig(evict_policy="lfu"))
    assert Trainer(RunConfig(), lfu, mc, device="cpu").maintenance() == {"evicted": 0}


def test_train_loop_logs_loss_auc_and_eval(tmp_path):
    """train(): the loop, its JSONL log lines and the probe-only eval."""
    import json

    from meepoembedding_tpu_torch.data import SyntheticConfig, SyntheticStream
    from meepoembedding_tpu_torch.metrics import JsonlLogger
    from meepoembedding_tpu_torch.train import train

    mc = ModelConfig(num_dense_features=4, num_sparse_features=3, embedding_dim=8,
                     bottom_mlp=(16, 8), top_mlp=(16, 1))
    rc = RunConfig(batch_size=64, steps=4, log_every=2, eval_every=2)
    data = dict(num_dense=4, num_sparse=3, batch_size=64, vocab_per_feature=300)
    log = JsonlLogger(str(tmp_path / "log.jsonl"), echo=False)
    tr = train(rc, TableConfig(dim=8, capacity=1024), mc,
               SyntheticStream(SyntheticConfig(**data, seed=1)), logger=log,
               eval_stream=SyntheticStream(SyntheticConfig(**data, seed=2)), device="cpu")
    log.close()
    lines = [json.loads(x) for x in (tmp_path / "log.jsonl").read_text().splitlines()]
    train_lines = [x for x in lines if "loss" in x]
    eval_lines = [x for x in lines if "eval_loss" in x]
    assert [x["step"] for x in train_lines] == [2, 4] and len(eval_lines) == 2
    assert all(np.isfinite(x["loss"]) and 0 <= x["auc"] <= 1 for x in train_lines)
    assert train_lines[-1]["ctr_inserts"] == tr.counters()["inserts"] > 0
    assert all(np.isfinite(x["eval_loss"]) for x in eval_lines)
