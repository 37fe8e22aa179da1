"""The port's checkpoint writer against the JAX package's, on the CPU.

- Cross-restore both ways is bit-exact: a port Trainer's checkpoint
  restores into the JAX Trainer (`restore_shards` and `load_dense` with its
  templates) with every row, parameter and Adam leaf equal, and a JAX
  checkpoint carried through the port (load, then save) comes back to the
  JAX package unchanged.
- From one table state, the port's part files, single-file async layout,
  counters sidecar and manifest equal the JAX package's array for array
  (dtype and bits), at f32 and bf16 and with a full-dim optimizer.
- Streamed parts resume, a changed chunk size is refused, a crashed save
  never clobbers the committed checkpoint, the counters travel with it,
  and the async save equals the sync one, is isolated from later in-place
  steps and surfaces its failure on `wait`."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_train_parity import configs, jax_step, numpy_planes, to_torch_shard

from meepoembedding_tpu import checkpoint as jckpt
from meepoembedding_tpu.config import OptimizerConfig as JOptimizerConfig
from meepoembedding_tpu.config import TableConfig as JTableConfig
from meepoembedding_tpu.data.synthetic import SyntheticConfig, SyntheticStream
from meepoembedding_tpu.table import hashing as jh
from meepoembedding_tpu.table import layout as jl
from meepoembedding_tpu.table import runtime as jrt
from meepoembedding_tpu.train import Trainer as JTrainer
from meepoembedding_tpu_torch import checkpoint as tckpt
from meepoembedding_tpu_torch.config import OptimizerConfig, TableConfig
from meepoembedding_tpu_torch.table import layout as tl
from meepoembedding_tpu_torch.table.runtime import DynamicEmbeddingTable
from meepoembedding_tpu_torch.train import Trainer
from meepoembedding_tpu_torch.weights import from_jax_params, to_jax_adam_state, to_jax_params

torch.set_num_threads(1)


def _rows_by_id(arrs: dict) -> dict:
    """{name: array} of export arrays, rows sorted by id."""
    order = np.argsort(arrs["ids"])
    return {k: v[order] for k, v in arrs.items()}


def _assert_same_rows(a: dict, b: dict):
    a, b = _rows_by_id(a), _rows_by_id(b)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k].view(np.int32) if a[k].dtype == np.float32 else a[k],
                                      b[k].view(np.int32) if b[k].dtype == np.float32 else b[k],
                                      err_msg=k)


def _trainers(steps=2):
    """A JAX and a port Trainer trained `steps` steps from one state."""
    (jrc, jtc, jmc), (rc, tc, mc), data = configs(16, 1, "rowwise_adagrad", {}, steps=6)
    jt = JTrainer(jrc, jtc, jmc)
    tt = Trainer(rc, tc, mc, device="cpu")
    from_jax_params(tt.model, jax.tree_util.tree_map(np.asarray, jt.params))
    batches = list(SyntheticStream(SyntheticConfig(**data)).batches(6))
    for b in batches[:steps]:
        jax_step(jt, b)
        tt.train_step(b)
    return jt, tt, batches[steps:], (jrc, jtc, jmc), (rc, tc, mc)


def _jax_dense(jt) -> tuple:
    return ([np.asarray(x) for x in jax.tree_util.tree_leaves(jt.params)],
            [np.asarray(x) for x in jax.tree_util.tree_leaves(jt.opt_state)])


def test_port_checkpoint_restores_into_jax_trainer(tmp_path):
    _, tt, _, jcfgs, _ = _trainers()
    path = str(tmp_path / "ck")
    m = tt.save_checkpoint(path, extras={"epoch": 3})
    assert m["step"] == 2 and m["dense"] == ["opt_state", "params"] and m["extras"] == {"epoch": 3}
    j2 = JTrainer(*jcfgs)
    j2.load_checkpoint(path)  # restore_shards + load_dense with its templates
    assert j2.step == 2
    _assert_same_rows(jckpt.export_shard_arrays(j2.spec, j2.shard),
                      tckpt.export_shard_arrays(tt.spec, tt.shard))
    params, opt = _jax_dense(j2)
    for got, want in zip(params, to_jax_params(tt.model)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(opt, to_jax_adam_state(tt.opt_state, tt.model)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert int(opt[-1]) == 2


def test_jax_checkpoint_round_trips_through_the_port(tmp_path):
    jt, _, _, jcfgs, tcfgs = _trainers()
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    jt.save_checkpoint(a)
    tt = Trainer(*tcfgs, device="cpu")
    tt.load_checkpoint(a)
    tt.save_checkpoint(b)
    j2 = JTrainer(*jcfgs)
    j2.load_checkpoint(b)
    _assert_same_rows(jckpt.export_shard_arrays(j2.spec, j2.shard),
                      jckpt.export_shard_arrays(jt.spec, jt.shard))
    for got, want in zip(_jax_dense(j2), _jax_dense(jt)):
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
    assert jckpt.read_manifest(b)["counters"] == jckpt.read_manifest(a)["counters"]


def _table_state(value_dtype, kind, n=3000, seed=0):
    """(JAX shard, port shard, specs) holding one random state: rows, freq,
    last and optimizer state from the JAX package's insert."""
    table = dict(dim=8, capacity=4096, value_dtype=value_dtype)
    jspec = jl.TableSpec.from_config(JTableConfig(**table, optimizer=JOptimizerConfig(kind=kind)))
    tspec = tl.TableSpec.from_config(TableConfig(**table, optimizer=OptimizerConfig(kind=kind)))
    rng = np.random.default_rng(seed)
    ids = rng.integers(-(2**63), 2**63 - 1, size=n, dtype=np.int64)
    hi, lo = jh.split_ids(ids)
    full = tuple(jnp.asarray(rng.normal(size=(n, 8)).astype(np.float32))
                 for _ in range(jspec.optimizer.num_fulldim_slots()))
    jshard, _ = jrt._insert(
        jspec, jl.alloc_shard(jspec), jnp.asarray(hi), jnp.asarray(lo),
        jnp.asarray(rng.normal(size=(n, 8)).astype(np.float32)), jnp.ones((n,), bool),
        jnp.int32(9), jnp.asarray(rng.integers(1, 50, size=n).astype(np.int32)),
        jnp.asarray(rng.random(n).astype(np.float32)), full,
        jnp.asarray(rng.integers(0, 9, size=n).astype(np.int32)))
    return jshard, to_torch_shard(numpy_planes(jshard), tspec), jspec, tspec


def _assert_same_files(a: str, b: str):
    """Two checkpoint directories hold the same manifest and files, and each
    npz the same arrays in the same order, dtype and bits."""
    ma, mb = jckpt.read_manifest(a), jckpt.read_manifest(b)
    assert ma == mb
    ga, gb = os.path.join(a, ma["dir"]), os.path.join(b, mb["dir"])
    files = sorted(os.listdir(ga))
    assert files == sorted(os.listdir(gb))
    for f in files:
        if f.endswith(".npy"):
            x, y = np.load(os.path.join(ga, f)), np.load(os.path.join(gb, f))
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y, err_msg=f)
            continue
        with np.load(os.path.join(ga, f)) as za, np.load(os.path.join(gb, f)) as zb:
            assert za.files == zb.files, f
            for k in za.files:
                assert za[k].dtype == zb[k].dtype, (f, k)
                assert za[k].tobytes() == zb[k].tobytes(), (f, k)
    return files


@pytest.mark.parametrize("value_dtype,kind", [
    ("float32", "rowwise_adagrad"), ("bfloat16", "rowwise_adagrad"), ("float32", "adam"),
    ("bfloat16", "adam"),
])
def test_part_files_equal_the_jax_save(tmp_path, monkeypatch, value_dtype, kind):
    monkeypatch.setenv("MEEPO_CKPT_CHUNK_ROWS", "1000")  # 3 parts
    jshard, tshard, jspec, tspec = _table_state(value_dtype, kind)
    ja, ta = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save(ja, jspec, [jshard], 9, extras={"k": 1})
    tckpt.save(ta, tspec, [tshard], 9, extras={"k": 1})
    files = _assert_same_files(ja, ta)
    assert sum(".part" in f for f in files) == 3 and "shard-00000.counters.npy" in files
    if value_dtype == "bfloat16":
        with np.load(os.path.join(ta, "step-9", "shard-00000.part0000.npz")) as z:
            assert z["values@bf16"].dtype == np.uint16
    # the async saver's single-file layout (values widened to f32)
    jsaver, tsaver = jckpt.AsyncCheckpointer(), tckpt.AsyncCheckpointer()
    jsaver.save(str(tmp_path / "ja"), jspec, [jshard], 9)
    tsaver.save(str(tmp_path / "ta"), tspec, [tshard], 9)
    jsaver.wait()
    tsaver.wait()
    assert _assert_same_files(str(tmp_path / "ja"), str(tmp_path / "ta")) == [
        "shard-00000.counters.npy", "shard-00000.npz"]


def test_compressed_parts_equal_the_jax_save(tmp_path, monkeypatch):
    monkeypatch.setenv("MEEPO_CKPT_COMPRESS", "1")
    jshard, tshard, jspec, tspec = _table_state("float32", "rowwise_adagrad", n=500)
    jckpt.save(str(tmp_path / "j"), jspec, [jshard], 9)
    tckpt.save(str(tmp_path / "t"), tspec, [tshard], 9)
    _assert_same_files(str(tmp_path / "j"), str(tmp_path / "t"))
    t2 = DynamicEmbeddingTable(TableConfig(dim=8, capacity=4096), device="cpu")
    t2.load(str(tmp_path / "t"))
    assert len(t2) == 500


def _trained_table(n_ids=500, seed=0):
    t = DynamicEmbeddingTable(TableConfig(dim=8, capacity=4096), device="cpu")
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 2**40, size=n_ids, dtype=np.int64)
    for _ in range(2):
        rows = t.lookup(ids, train=True)
        t.apply_grads(rows * 0.1 + 0.01)
    return t


def test_streamed_parts_and_resume(tmp_path, monkeypatch):
    """Small parts; an interrupted save resumes by skipping the parts that
    exist (their files untouched), and a resume against a changed table
    aborts."""
    monkeypatch.setenv("MEEPO_CKPT_CHUNK_ROWS", "128")
    t = _trained_table()
    path = str(tmp_path / "ck")
    t.save(path)
    m = tckpt.read_manifest(path)
    assert len([f for f in os.listdir(os.path.join(path, m["dir"])) if ".part" in f]) == 4
    t2 = DynamicEmbeddingTable(t.cfg, device="cpu")
    t2.load(path)
    _assert_same_rows(tckpt.export_shard_arrays(t.spec, t.shard),
                      tckpt.export_shard_arrays(t2.spec, t2.shard))

    t.step += 1
    gen2 = os.path.join(path, f"step-{t.step}")
    os.makedirs(gen2)
    tckpt.save_shard_streamed(gen2, 0, t.spec, t.shard, 128)
    names = sorted(f for f in os.listdir(gen2) if ".part" in f)
    for f in names[2:]:
        os.unlink(os.path.join(gen2, f))
    mtimes = {f: os.path.getmtime(os.path.join(gen2, f)) for f in names[:2]}
    t.save(path)
    for f, mt in mtimes.items():
        assert os.path.getmtime(os.path.join(gen2, f)) == mt, f"resume rewrote {f}"
    t3 = DynamicEmbeddingTable(t.cfg, device="cpu")
    t3.load(path)
    _assert_same_rows(tckpt.export_shard_arrays(t.spec, t.shard),
                      tckpt.export_shard_arrays(t3.spec, t3.shard))

    other = _trained_table(n_ids=300, seed=9)
    gen3 = os.path.join(path, "step-999")
    os.makedirs(gen3)
    tckpt.save_shard_streamed(gen3, 0, t.spec, t.shard, 128)
    with pytest.raises(RuntimeError, match="resume mismatch"):
        tckpt.save_shard_streamed(gen3, 0, other.spec, other.shard, 128)


def test_streamed_resume_rejects_chunk_size_change(tmp_path):
    t = _trained_table()
    gen = str(tmp_path / "gen")
    os.makedirs(gen)
    tckpt.save_shard_streamed(gen, 0, t.spec, t.shard, 64)
    small = sorted(f for f in os.listdir(gen) if ".part" in f)
    assert len(small) == 8
    for f in small[1:-1]:
        os.unlink(os.path.join(gen, f))
    with pytest.raises(RuntimeError, match="chunk_rows"):
        tckpt.save_shard_streamed(gen, 0, t.spec, t.shard, 128)

    # a stale part beyond what a 128-row save writes is deleted
    gen2 = str(tmp_path / "gen2")
    os.makedirs(gen2)
    with open(os.path.join(gen2, tckpt._part_name(0, 7)), "wb") as f:
        f.write(b"stale")
    n_live = tckpt.save_shard_streamed(gen2, 0, t.spec, t.shard, 128)
    names = sorted(f for f in os.listdir(gen2) if ".part" in f)
    assert names == [tckpt._part_name(0, p) for p in range(-(-n_live // 128))]
    got = 0
    for f in names:
        with np.load(os.path.join(gen2, f)) as z:
            assert int(z["chunk_rows"]) == 128 and int(z["row_off"]) == got
            got += z["ids"].shape[0]
    assert got == n_live == 500


def test_corrupt_save_never_clobbers(tmp_path):
    """The manifest is the commit point: a second save that died midway (a
    garbage generation, a stray temporary) leaves the first loadable."""
    t = _trained_table(n_ids=100)
    p = str(tmp_path / "c")
    t.save(p)
    os.makedirs(os.path.join(p, "step-999"))
    with open(os.path.join(p, "step-999", "shard-00000.npz"), "wb") as f:
        f.write(b"garbage")
    with open(os.path.join(p, ".tmp-ckpt-dead"), "wb") as f:
        f.write(b"garbage")
    for loader in (DynamicEmbeddingTable(t.cfg, device="cpu"),
                   jrt.DynamicEmbeddingTable(JTableConfig(dim=8, capacity=4096))):
        loader.load(p)
        assert len(loader) == 100
    t.save(p)  # a re-save at the same step lands in a fresh generation and prunes
    assert tckpt.read_manifest(p)["dir"] == "step-2.1"
    assert sorted(x for x in os.listdir(p) if x.startswith("step-")) == ["step-2.1"]


def test_counters_travel_with_the_checkpoint(tmp_path):
    t = _trained_table(n_ids=600)
    t.remove(np.arange(5))
    before = t.counters()
    assert before["inserts"] > 0 and before["hits"] > 0
    path = str(tmp_path / "ck")
    t.save(path)
    m = tckpt.read_manifest(path)
    assert m["counters"] == [int(x) for x in t.shard.counters]
    np.testing.assert_array_equal(
        np.load(os.path.join(path, m["dir"], "shard-00000.counters.npy")), t.shard.counters.numpy())
    t2 = DynamicEmbeddingTable(t.cfg, device="cpu")
    t2.load(path)
    j2 = jrt.DynamicEmbeddingTable(JTableConfig(dim=8, capacity=4096))
    j2.load(path)
    for k in ("hits", "misses", "inserts", "evictions", "denied", "erases"):
        assert t2.counters()[k] == j2.counters()[k] == before[k], k


def test_async_save_matches_sync(tmp_path):
    _, tt, _, _, _ = _trainers()
    pa, ps = str(tmp_path / "a"), str(tmp_path / "s")
    assert tt.save_checkpoint(pa, async_=True) == {"async": True, "step": 2}
    tt.save_checkpoint(ps)  # joins the async save first
    tt.finish_saves()
    _assert_same_rows(next(tckpt.iter_rows(pa)), next(tckpt.iter_rows(ps)))
    ma, ms = tckpt.read_manifest(pa), tckpt.read_manifest(ps)
    assert ma["counts"] == ms["counts"] and ma["step"] == ms["step"] == 2
    assert ma["counters"] == ms["counters"]
    for name in ("params", "opt_state"):
        for x, y in zip(tckpt.load_dense(pa, name), tckpt.load_dense(ps, name)):
            np.testing.assert_array_equal(x, y)


def test_async_save_snapshot_isolated_from_later_steps(tmp_path):
    """Steps that update the planes and the tower in place after save()
    returns do not reach the checkpoint."""
    _, tt, later, _, _ = _trainers()
    want_rows = tckpt.export_shard_arrays(tt.spec, tt.shard)
    want_params = to_jax_params(tt.model)
    want_opt = to_jax_adam_state(tt.opt_state, tt.model)
    p = str(tmp_path / "snap")
    tt.save_checkpoint(p, async_=True)
    for b in later[:3]:
        tt.train_step(b)
    tt.finish_saves()
    assert tckpt.read_manifest(p)["step"] == 2
    _assert_same_rows(next(tckpt.iter_rows(p)), want_rows)
    for x, y in zip(tckpt.load_dense(p, "params"), want_params):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(tckpt.load_dense(p, "opt_state"), want_opt):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(to_jax_params(tt.model)[0], want_params[0])


def test_async_save_failure_surfaces_on_wait(tmp_path):
    _, tt, _, _, _ = _trainers(steps=1)
    blocker = tmp_path / "blocked"
    blocker.write_text("not a directory")
    tt.save_checkpoint(str(blocker), async_=True)
    with pytest.raises(OSError):
        tt.finish_saves()
    good = str(tmp_path / "good")
    tt.save_checkpoint(good, async_=True)
    tt.finish_saves()
    assert tckpt.read_manifest(good)["step"] == tt.step == 1


def test_train_loop_checkpoints_every_n_steps(tmp_path):
    """train(): async saves every ckpt_every steps, the last one joined."""
    from meepoembedding_tpu_torch.data import SyntheticConfig as TSyntheticConfig
    from meepoembedding_tpu_torch.data import SyntheticStream as TSyntheticStream
    from meepoembedding_tpu_torch.metrics import JsonlLogger
    from meepoembedding_tpu_torch.train import train

    _, (rc, tc, mc), data = configs(8, 1, "rowwise_adagrad", {}, steps=4)
    tr = train(rc, tc, mc, TSyntheticStream(TSyntheticConfig(**data)),
               logger=JsonlLogger(echo=False), ckpt_dir=str(tmp_path / "ck"), ckpt_every=2,
               device="cpu")
    m = tckpt.read_manifest(str(tmp_path / "ck"))
    assert m["step"] == tr.step == 4 and m["counts"] == [len(next(tckpt.iter_rows(
        str(tmp_path / "ck")))["ids"])] == [int(tr.shard.cnt.sum())]
