"""Parity of the port's table ops with the JAX reference (`xla_ops`).

A sequence of `insert_rows` batches fills a 64-bucket table past 0.8 load
with `max_probe_rounds=2`, so pair-overflow drops occur; batches carry fresh
ids, overwrites of earlier ids and invalid padding. After every batch the
landed mask must match; at the end every [nb, 128] and [nb] plane, the
counters, the values of every slot and the probe results must be identical.
The JAX package stores values packed 128 // dim to a row; its
`gather_values` unpacks them for the comparison."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meepoembedding_tpu.config import TableConfig as JTableConfig
from meepoembedding_tpu.table import hashing as jh
from meepoembedding_tpu.table import layout as jl
from meepoembedding_tpu.table import runtime as jrt
from meepoembedding_tpu.table import xla_ops as jx
from meepoembedding_tpu_torch.config import TableConfig
from meepoembedding_tpu_torch.table import layout as tl
from meepoembedding_tpu_torch.table import table_ops as tx

torch.set_num_threads(1)

NB, DIM, BATCH = 64, 8, 2048


def _specs(**kw):
    cfg = dict(dim=DIM, capacity=NB * 128, max_probe_rounds=2, **kw)
    jspec = jl.TableSpec.from_config(JTableConfig(**cfg))
    tspec = tl.TableSpec.from_config(TableConfig(**cfg))
    return jspec, tspec


def _batches(seed: int, nbatch: int = 5, fresh: int = 1500, reused: int = 200):
    """(ids, rows, freq, last, accum) batches of BATCH rows: `fresh` new ids,
    `reused` ids of earlier batches (overwrites), the rest invalid."""
    rng = np.random.default_rng(seed)
    seen = np.zeros((0,), np.int64)
    for b in range(nbatch):
        new = rng.integers(-(2**63), 2**63 - 1, size=fresh, dtype=np.int64)
        old = rng.choice(seen, size=min(reused, len(seen)), replace=False)
        pad = np.full(BATCH - len(new) - len(old), jh.EMPTY_ID, np.int64)
        ids = rng.permutation(np.concatenate([new, old, pad]))
        seen = np.concatenate([seen, new])
        yield (
            ids,
            rng.normal(size=(BATCH, DIM)).astype(np.float32),
            rng.integers(1, 1000, size=BATCH).astype(np.int32),
            rng.integers(0, 50, size=BATCH).astype(np.int32),
            rng.random(BATCH).astype(np.float32),
        )


def _assert_planes_equal(jspec, jshard, tshard):
    for name in ("key_hi", "key_lo", "cnt", "ovf", "freq", "last", "counters"):
        np.testing.assert_array_equal(
            getattr(tshard, name).numpy(), np.asarray(getattr(jshard, name)), err_msg=name
        )
    np.testing.assert_array_equal(tshard.opt_rowwise[0].numpy(),
                                  np.asarray(jshard.opt_rowwise[0]))
    all_slots = jnp.arange(jspec.capacity, dtype=jnp.int32)
    np.testing.assert_array_equal(
        tshard.values.numpy(), np.asarray(jx.gather_values(jspec, jshard.values, all_slots))
    )


@pytest.mark.parametrize("mode", ["assign", "restore", "insert_cap"])
def test_insert_rows_sequence_matches(mode):
    jspec, tspec = _specs(insert_cap=512 if mode == "insert_cap" else None)
    jshard, tshard = jl.alloc_shard(jspec), tl.alloc_shard(tspec, "cpu")
    drops = 0
    for step, (ids, rows, freq, last, accum) in enumerate(_batches(seed=len(mode))):
        hi, lo = jh.split_ids(ids)
        valid = jh.is_valid(hi, lo)
        state = dict(freq=freq, accum=accum, last=last) if mode == "restore" else {}
        jshard, jok = jrt._insert(
            jspec, jshard, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(rows),
            jnp.asarray(valid), jnp.int32(step),
            *(jnp.asarray(state[k]) if state else None for k in ("freq", "accum")),
            last=jnp.asarray(last) if state else None,
        )
        tok = tx.insert_rows(
            tspec, tshard, torch.from_numpy(hi), torch.from_numpy(lo),
            torch.from_numpy(rows), torch.from_numpy(valid), step,
            **{k: torch.from_numpy(v) for k, v in state.items()},
        )
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok), err_msg=f"batch {step}")
        drops += int((valid & ~tok.numpy()).sum())
    assert drops > 0, "the sequence must overflow some bucket pairs"
    _assert_planes_equal(jspec, jshard, tshard)

    # probe: every id ever offered, unknown ids and invalid padding
    ids = np.concatenate([b[0] for b in _batches(seed=len(mode))])
    ids = np.concatenate([ids, np.arange(1, 500, dtype=np.int64)])
    hi, lo = jh.split_ids(ids)
    valid = jh.is_valid(hi, lo)
    jp = jx.probe(jspec, jshard, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid))
    tp = tx.probe(tspec, tshard, torch.from_numpy(hi), torch.from_numpy(lo),
                  torch.from_numpy(valid))
    np.testing.assert_array_equal(tp.slot.numpy(), np.asarray(jp.slot))
    np.testing.assert_array_equal(tp.found.numpy(), np.asarray(jp.found))
    rows = tx.lookup_rows(tshard, torch.where(tp.found, tp.slot, -1))
    jrows = jx.lookup_rows(jspec, jshard, jnp.where(jp.found, jp.slot, -1))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))


@pytest.mark.parametrize("insert_cap", [None, 300])
def test_plan_insert_matches(insert_cap):
    """One planning call on a half-full table: slots, ok, cnt and ovf."""
    jspec, tspec = _specs(insert_cap=insert_cap)
    jshard, tshard = jl.alloc_shard(jspec), tl.alloc_shard(tspec, "cpu")
    batches = _batches(seed=42, nbatch=3, fresh=1700, reused=0)
    for step, (ids, rows, *_rest) in enumerate(batches):
        hi, lo = jh.split_ids(ids)
        valid = jh.is_valid(hi, lo)
        if step < 2:  # fill
            jshard, _ = jrt._insert(jspec, jshard, jnp.asarray(hi), jnp.asarray(lo),
                                    jnp.asarray(rows), jnp.asarray(valid), jnp.int32(0),
                                    None, None)
            tx.insert_rows(tspec, tshard, torch.from_numpy(hi), torch.from_numpy(lo),
                           torch.from_numpy(rows), torch.from_numpy(valid), 0)
            continue
        jplan = jx.plan_insert(jspec, jshard, jnp.asarray(hi), jnp.asarray(lo),
                               jnp.asarray(valid))
        tplan = tx.plan_insert(tspec, tshard, torch.from_numpy(hi), torch.from_numpy(lo),
                               torch.from_numpy(valid))
        for name in ("slot", "ok", "cnt", "ovf"):
            np.testing.assert_array_equal(getattr(tplan, name).numpy(),
                                          np.asarray(getattr(jplan, name)), err_msg=name)


def test_bf16_values_plane_matches():
    jspec, tspec = _specs()
    jspec = dataclasses.replace(jspec, value_dtype="bfloat16")
    tspec = dataclasses.replace(tspec, value_dtype="bfloat16")
    jshard, tshard = jl.alloc_shard(jspec), tl.alloc_shard(tspec, "cpu")
    for step, (ids, rows, *_rest) in enumerate(_batches(seed=7, nbatch=2)):
        hi, lo = jh.split_ids(ids)
        valid = jh.is_valid(hi, lo)
        jshard, _ = jrt._insert(jspec, jshard, jnp.asarray(hi), jnp.asarray(lo),
                                jnp.asarray(rows), jnp.asarray(valid), jnp.int32(step),
                                None, None)
        tx.insert_rows(tspec, tshard, torch.from_numpy(hi), torch.from_numpy(lo),
                       torch.from_numpy(rows), torch.from_numpy(valid), step)
    all_slots = jnp.arange(jspec.capacity, dtype=jnp.int32)
    want = np.asarray(jx.gather_values(jspec, jshard.values, all_slots)).view(np.int16)
    np.testing.assert_array_equal(tshard.values.view(torch.int16).numpy(), want)


@pytest.mark.parametrize("in_order", [False, True], ids=["keys", "received_order"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lookup_probe_matches(dtype, in_order):
    """`lookup_probe` against the reference's probe and a take of its values
    plane, on one table: keys present, absent (never inserted) and invalid
    padding; with `in_order`, the rows come back
    in the sharded owner's received order (indices with repeats)."""
    jspec, tspec = (dataclasses.replace(s, value_dtype=dtype) for s in _specs())
    tshard = tl.alloc_shard(tspec, "cpu")
    offered = []
    for step, (ids, rows, *_rest) in enumerate(_batches(seed=11, nbatch=3)):
        hi, lo = jh.split_ids(ids)
        tx.insert_rows(tspec, tshard, torch.from_numpy(hi), torch.from_numpy(lo),
                       torch.from_numpy(rows), torch.from_numpy(jh.is_valid(hi, lo)), step)
        offered.append(ids)
    jshard = jl.alloc_shard(jspec)._replace(
        key_hi=jnp.asarray(tshard.key_hi.numpy()), key_lo=jnp.asarray(tshard.key_lo.numpy()))
    rng = np.random.default_rng(5)
    ids = np.unique(np.concatenate(offered + [rng.integers(1, 2**62, 300, dtype=np.int64)]))
    ids = rng.permutation(np.concatenate([ids, np.full(64, jh.EMPTY_ID, np.int64)]))
    hi, lo = jh.split_ids(ids)
    valid = jh.is_valid(hi, lo)
    order = rng.integers(0, len(ids), 3 * len(ids)) if in_order else np.arange(len(ids))

    jp = jx.probe(jspec, jshard, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid))
    bits = torch.int16 if dtype == "bfloat16" else torch.int32
    plane = tshard.values.view(bits).numpy()  # the reference's plane, as [capacity, dim]
    jslot = jnp.asarray(jp.slot)[order]
    want = jnp.where((jslot >= 0)[:, None], jnp.take(jnp.asarray(plane), jnp.clip(jslot, 0),
                                                     axis=0), 0)
    rows, pr = tx.lookup_probe(tspec, tshard, torch.from_numpy(hi), torch.from_numpy(lo),
                               torch.from_numpy(valid),
                               order=torch.from_numpy(order) if in_order else None)
    np.testing.assert_array_equal(pr.slot.numpy(), np.asarray(jp.slot))
    np.testing.assert_array_equal(pr.found.numpy(), np.asarray(jp.found))
    assert rows.dtype == tshard.values.dtype and rows.shape == (len(order), DIM)
    np.testing.assert_array_equal(rows.view(bits).numpy(), np.asarray(want))
    found = np.asarray(jp.found)[order]
    assert found.any() and (~found & valid[order]).any() and (~valid[order]).any()
    assert not rows[torch.from_numpy(~found)].any()
