"""The JAX check compares whole top-level names, and the harness and its
reference load neither JAX nor the JAX package (the reference loads
nothing of the port either)."""

from __future__ import annotations

import os
import subprocess
import sys

import _perfbench_tiny
import run


def test_top_level_names_are_compared_whole():
    mods = ["meepoembedding_tpu_torch", "meepoembedding_tpu_torch.train", "jaxtyping",
            "numpy", "flaxen.x"]
    assert run.forbidden_modules(mods) == []
    assert run.forbidden_modules(mods + ["jax.numpy", "meepoembedding_tpu.table"]) == [
        "jax.numpy", "meepoembedding_tpu.table"]
    assert run.forbidden_modules(["jaxlib", "flax.linen"]) == ["flax.linen", "jaxlib"]


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, check=True,
                         cwd=_perfbench_tiny.BENCH)
    return set(out.stdout.split())


def test_the_harness_loads_no_jax():
    top = _loaded("import sys; sys.path.insert(0, '..')\n"
                  "import run\nfrom harness import train_cell, serve_cell, trace, instrument\n"
                  "instrument._targets()")
    assert "meepoembedding_tpu_torch" in top
    assert not top & set(run.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    top = _loaded("import reference.dlrm")
    assert not top & {"meepoembedding_tpu_torch", *run.FORBIDDEN}


def test_run_refuses_without_a_card():
    # the card, if the machine has one, is hidden from the run
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "dlrm-kaggle.train",
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=_perfbench_tiny.ROOT,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 2 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr
