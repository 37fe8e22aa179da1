"""The port's copies of the spill backends against the JAX package's: the
same operation sequence on each kind (host C++, python, disk, redis through
`tests/fake_resp.py`) gives the same results, call for call: found masks,
rows, lengths and exports (in key order). The port's host store builds
`csrc/host_kv.cc` into its own library under `build/torch_native/`."""

import numpy as np
import pytest
from fake_resp import FakeRespServer

from meepoembedding_tpu import backends as jb
from meepoembedding_tpu_torch import backends as tb
from meepoembedding_tpu_torch.backends import host_kv

WIDTH = 6
EMPTY = np.int64(-(2**63))


def _make(mod, name, tmp_path, tag):
    if name == "disk":
        return mod.make_backend("disk", width=WIDTH, path=str(tmp_path / f"{tag}.log"))
    if name == "redis":
        srv = FakeRespServer()
        return mod.make_backend("redis", width=WIDTH, port=srv.port, prefix=tag), srv
    return mod.make_backend(name, width=WIDTH)


def _export(b) -> tuple:
    keys, rows = [], []
    for k, r in b.export(chunk=7):
        keys.append(k)
        rows.append(r)
    if not keys:
        return np.zeros((0,), np.int64), np.zeros((0, WIDTH), np.float32)
    k, r = np.concatenate(keys), np.concatenate(rows)
    order = np.argsort(k)
    return k[order], r[order]


def _script(b, rng):
    """An operation sequence; returns every observable result."""
    out = []
    keys = rng.choice(2**62, size=60, replace=False).astype(np.int64) - 2**61
    b.insert_batch(keys, rng.normal(size=(60, WIDTH)).astype(np.float32))
    dup = np.array([keys[0], keys[1], keys[0], EMPTY], np.int64)  # last write wins, EMPTY skipped
    b.insert_batch(dup, rng.normal(size=(4, WIDTH)).astype(np.float32))
    out.append(len(b))
    q = np.concatenate([keys[:30], np.arange(5, dtype=np.int64)])
    out += list(b.lookup_batch(q))
    out.append(b.erase_batch(np.concatenate([keys[::3], np.array([7, 8], np.int64)])))
    out.append(len(b))
    out += list(_export(b))
    out += list(b.lookup_batch(keys))
    b.clear()
    out.append(len(b))
    out += list(b.lookup_batch(keys[:5]))
    return out


def test_registries_match():
    assert tb.available_backends() == jb.available_backends() == ["disk", "host", "python", "redis"]
    with pytest.raises(KeyError):
        tb.make_backend("nope", width=4)


@pytest.mark.parametrize("name", ["host", "python", "disk", "redis"])
def test_backend_matches_jax(name, tmp_path):
    servers = []
    stores = []
    for mod, tag in ((jb, "j"), (tb, "t")):
        b = _make(mod, name, tmp_path, tag)
        if name == "redis":
            b, srv = b
            servers.append(srv)
        stores.append(b)
    try:
        assert isinstance(stores[1], tb.KVBackend)
        want, got = (_script(b, np.random.default_rng(1)) for b in stores)
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g, w, err_msg=f"result {i}")
    finally:
        for b in stores:
            if hasattr(b, "close"):
                b.close()
        for srv in servers:
            srv.close()


def test_disk_store_reopens_with_the_jax_log(tmp_path):
    """Either package's disk store reads the other's log: the format is one."""
    rng = np.random.default_rng(2)
    keys = np.arange(1, 40, dtype=np.int64) * 7919
    rows = rng.normal(size=(39, WIDTH)).astype(np.float32)
    path = str(tmp_path / "kv.log")
    j = jb.make_backend("disk", width=WIDTH, path=path)
    j.insert_batch(keys, rows)
    j.erase_batch(keys[:9])
    j.close()
    t = tb.make_backend("disk", width=WIDTH, path=path)
    assert len(t) == 30
    got, found = t.lookup_batch(keys)
    np.testing.assert_array_equal(found, np.arange(39) >= 9)
    np.testing.assert_array_equal(got[9:], rows[9:])
    t.close()


def test_host_store_builds_its_own_library():
    b = tb.make_backend("host", width=WIDTH)
    assert host_kv.library_path().is_file()
    assert host_kv.library_path().parent.parts[-2:] == ("build", "torch_native")
    b.insert_batch(np.array([3], np.int64), np.ones((1, WIDTH), np.float32))
    assert len(b) == 1
