"""The port's entry points (`meepoembedding_tpu_torch/entry.py`)
against the repository root's `__graft_entry__.py`.

`entry()`'s forward, with the JAX entry's tower carried over by
`weights.from_jax_params`, equals the JAX forward within rtol 1e-5 / atol
1e-6 on the same batch: once on the empty table, once on the rows both
tables restored from one checkpoint the JAX package wrote.
`dryrun_multichip(4, device="cpu")` runs its world of 4 gloo ranks (every
kind of sharded step, then serving through a front) in a subprocess with a
time limit."""

import os
import subprocess
import sys

import jax
import numpy as np
import torch

import __graft_entry__ as jentry
from meepoembedding_tpu import checkpoint as jckpt
from meepoembedding_tpu.table.layout import TableSpec as JTableSpec
from meepoembedding_tpu.train import Trainer as JTrainer
from meepoembedding_tpu_torch import checkpoint as tckpt
from meepoembedding_tpu_torch import entry as tentry
from meepoembedding_tpu_torch.table.layout import TableSpec
from meepoembedding_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _forwards(jax_shard=None, port_shard=None):
    """Both entries' logits of their example batch, the port's tower
    loaded with the JAX entry's params; the shards replaced when given."""
    jfn, jargs = jentry.entry()
    tfn, targs = tentry.entry(device="cpu")
    from_jax_params(targs[1], jargs[1])
    if jax_shard is not None:
        jargs = (jax_shard,) + tuple(jargs[1:])
        targs = (port_shard,) + tuple(targs[1:])
    want = np.asarray(jax.jit(jfn)(*jargs))
    with torch.no_grad():
        got = tfn(*targs).numpy()
    return got, want


def test_entry_matches_the_jax_entry_on_the_empty_table():
    got, want = _forwards()
    assert got.shape == want.shape == (256,)
    np.testing.assert_allclose(got, want, **TOL)


def test_entry_matches_the_jax_entry_on_restored_rows(tmp_path):
    """A JAX Trainer takes 2 steps of the entries' batch (its ids are the
    forward's) and saves; both restore it into their entry's table."""
    run, table_cfg, model_cfg = jentry._cfgs()
    tr = JTrainer(run, table_cfg, model_cfg)
    for _ in range(2):
        tr.train_step(jentry._batch(run, model_cfg))
    path = str(tmp_path / "ck")
    tr.save_checkpoint(path)
    jshards, _ = jckpt.restore_shards(JTableSpec.from_config(table_cfg, num_shards=1), path, 1)
    _, ttable, _ = tentry._cfgs()
    tshards, _ = tckpt.restore_shards(TableSpec.from_config(ttable, num_shards=1), path, 1,
                                      device="cpu")
    got, want = _forwards(jshards[0], tshards[0])
    np.testing.assert_allclose(got, want, **TOL)
    # the rows are there: the forward differs from the empty table's
    assert np.abs(got - _forwards()[0]).max() > 1e-4


def test_dryrun_multichip_four_cpu_ranks():
    code = ("from meepoembedding_tpu_torch.entry import dryrun_multichip\n"
            "dryrun_multichip(4, device='cpu')\nprint('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-4000:]
