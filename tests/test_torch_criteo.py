"""The port's Criteo input path against the JAX package's: the synthetic
writers give byte-equal files from one seed; `CriteoStream` gives equal
batches, batch for batch, through the native parser and the Python one,
for 2 hosts, .gz and `loop`, and equal to the JAX package's stream; the
native parser equals the Python one bit for bit on adversarial lines;
`PrefetchStream` keeps the order, stops at `steps`, forwards attributes and
raises the worker's error. Everything here is exact."""

import gzip
import shutil

import numpy as np
import pytest
import torch

from meepoembedding_tpu.data import criteo as jcriteo
from meepoembedding_tpu_torch.data import CriteoStream, PrefetchStream, criteo, criteo_native

torch.set_num_threads(1)


def _assert_batches_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("writer,kw", [
    ("write_synthetic_criteo", dict(seed=3)),
    ("write_synthetic_criteo_signal", dict(seed=7, stream_seed=101, vocab_per_feature=500)),
    ("write_synthetic_criteo_signal", dict(seed=11, vocab_per_feature=300, signal_scale=0.2,
                                           interaction_scale=2.5, interaction_rank=4,
                                           interaction_pairs=6)),
], ids=["plain", "signal", "interaction"])
def test_writers_are_byte_equal_to_jax(tmp_path, writer, kw):
    mine, ref = tmp_path / "mine.tsv", tmp_path / "ref.tsv"
    getattr(criteo, writer)(str(mine), 700, **kw)
    getattr(jcriteo, writer)(str(ref), 700, **kw)
    assert mine.read_bytes() == ref.read_bytes()


def test_constants_and_hash_match_jax():
    assert (criteo.NUM_DENSE, criteo.NUM_SPARSE, criteo.FEATURE_SHIFT) == (
        jcriteo.NUM_DENSE, jcriteo.NUM_SPARSE, jcriteo.FEATURE_SHIFT)
    for tok in ("", "0a1b2c3d", "deadbeef", "été", "x" * 40):
        assert criteo._hash_token(tok) == jcriteo._hash_token(tok)


@pytest.fixture(scope="module")
def tsv(tmp_path_factory):
    d = tmp_path_factory.mktemp("criteo")
    p = d / "s.tsv"
    criteo.write_synthetic_criteo_signal(str(p), 600, seed=5, vocab_per_feature=400)
    with open(p, "rb") as src, gzip.open(str(p) + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    return str(p)


@pytest.mark.parametrize("case", [
    dict(num_hosts=1), dict(num_hosts=2, host_id=0), dict(num_hosts=2, host_id=1),
    dict(gz=True), dict(loop=True, steps=14),
], ids=["one-host", "host0of2", "host1of2", "gz", "loop"])
def test_stream_native_equals_python_and_jax(tsv, case):
    case = dict(case)
    path = tsv + ".gz" if case.pop("gz", False) else tsv
    steps = case.pop("steps", None)
    native = CriteoStream(path, 64, parser="native", **case)
    python = CriteoStream(path, 64, parser="python", **case)
    assert (native.parser, python.parser) == ("native", "python")
    got = list(native.batches(steps))
    _assert_batches_equal(got, list(python.batches(steps)))
    _assert_batches_equal(got, list(jcriteo.CriteoStream(path, 64, **case).batches(steps)))
    lines = 600 // case.get("num_hosts", 1)
    assert len(got) == (steps if steps else lines // 64)


def test_native_parser_matches_python_bit_for_bit(tmp_path):
    """After tests/test_data.py: empty fields, a short line, float dense
    values, extra fields and an empty line."""
    p = tmp_path / "sample.tsv"
    criteo.write_synthetic_criteo(str(p), 300, seed=7)
    with open(p, "a") as fh:
        fh.write("1\t3.5\t-2\n")
        fh.write("0\t" + "\t".join([""] * 13) + "\t" + "\t".join(["deadbeef"] * 26)
                 + "\textra\tfields\n")
        fh.write("\n")
    lines = open(p).readlines()
    py = list(criteo.parse_lines(iter(lines), 64))
    nat = list(criteo_native.parse_lines_native(iter(lines), 64))
    assert len(py) == len(nat) == len(lines) // 64
    _assert_batches_equal(nat, py)
    _assert_batches_equal(py, list(jcriteo.parse_lines(iter(lines), 64)))


def test_native_library_is_built_into_build_torch_native():
    so = criteo_native.library_path()
    criteo_native.load()
    assert so.exists() and so.parent.name == "torch_native" and so.parent.parent.name == "build"
    assert CriteoStream("unused.tsv", 8).parser == "native"
    with pytest.raises(ValueError):
        CriteoStream("unused.tsv", 8, parser="fast")


def test_prefetch_keeps_order_steps_and_attributes(tsv):
    inner = CriteoStream(tsv, 64, loop=True)
    pre = PrefetchStream(inner, depth=2)
    assert pre.parser == inner.parser and pre.paths == [tsv]
    _assert_batches_equal(list(pre.batches(12)), list(inner.batches(12)))
    assert sum(1 for _ in pre.batches(3)) == 3


def test_prefetch_raises_the_workers_error():
    class Boom:
        def batches(self, steps=None):
            yield {"x": 1}
            raise RuntimeError("upstream died")

    it = PrefetchStream(Boom()).batches()
    assert next(it) == {"x": 1}
    with pytest.raises(RuntimeError, match="upstream died"):
        list(it)
