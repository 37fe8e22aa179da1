"""Helpers of the harness tests (`test_torch_bench_*.py`): the reference's
root scripts loaded as modules, the `MEEPO_*` environment, one run of a
reference script and of the port's harness on the same knobs, and a
wrapper of `kernels.row_merge_add` that fails on a repeated row."""

import importlib.util
import json
import os
import sys

import pytest
import torch

from meepoembedding_tpu_torch import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reference(name: str):
    """The root script `name`.py as a module (its main() not yet run)."""
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", os.path.join(REPO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def set_env(monkeypatch, knobs: dict) -> None:
    """Exactly `knobs` of the MEEPO_* variables."""
    for k in [k for k in os.environ if k.startswith("MEEPO_")]:
        monkeypatch.delenv(k)
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)


def both(name: str, port, knobs: dict, monkeypatch, capsys):
    """(the reference's JSON lines, its stderr, the port's `run` result, its
    stderr) on the same knobs."""
    set_env(monkeypatch, knobs)
    capsys.readouterr()
    reference(name).main()
    ref = capsys.readouterr()
    got = port.run(device="cpu")
    lines = [json.loads(x) for x in ref.out.splitlines() if x.startswith("{")]
    return lines, ref.err, got, capsys.readouterr().err


@pytest.fixture
def unique_rows_only(monkeypatch):
    """`row_merge_add`, wherever a port module holds it, wrapped to fail on
    an enabled row given twice (on the card such rows race; the plain
    version sums them, so no CPU result shows it); yields the list of its
    calls' enabled rows."""
    orig = kernels.row_merge_add
    calls = []

    class Checked:
        """The wrapper; reads the kernel's launch count through."""

        __name__ = "row_merge_add"

        @property
        def launches(self):
            return orig.launches

        def __call__(self, plane, vrow, upd):
            v = vrow[(vrow >= 0) & (vrow < plane.shape[0])]
            if torch.unique(v).numel() != v.numel():
                raise AssertionError(f"row_merge_add given {v.numel() - torch.unique(v).numel()}"
                                     " repeated rows")
            calls.append(v.numel())
            return orig(plane, vrow, upd)

    checked = Checked()
    for name, mod in list(sys.modules.items()):
        if name.startswith("meepoembedding_tpu_torch") and \
                getattr(mod, "row_merge_add", None) is orig:
            monkeypatch.setattr(mod, "row_merge_add", checked)
    with pytest.raises(AssertionError, match="repeated rows"):  # the wrapper sees repeats
        checked(torch.zeros(4, 2), torch.tensor([1, 1], dtype=torch.int32), torch.ones(2, 2))
    return calls
