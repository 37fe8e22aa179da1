"""Criteo Kaggle/Terabyte input path: a copy of
`meepoembedding_tpu/data/criteo.py` (numpy only), so that the port never
imports the JAX package. The two parse the same batches and write the same
bytes from the same seed.

Format: TSV lines `label \\t I1..I13 \\t C1..C26` where I* are ints (possibly
empty) and C* are 8-hex-char categorical hashes (possibly empty). The parser

  - log-transforms dense ints: x -> log(1 + max(x, 0));
  - maps categoricals to int64 ids namespaced per feature:
      id = (feature_index << 44) | (fnv1a32(token) & (2^44 - 1)),
    the synthetic stream's namespace, so one table serves all 26 features;
  - gives empty fields dense 0.0 / the per-feature "missing" id (value 0);
  - shards round-robin by line among hosts;
  - reads .gz transparently; batches are plain numpy dicts.

`CriteoStream` parses with the native parser (`criteo_native`, the
repository's `csrc/criteo_parse.cc`) when it builds, and records which
parser it runs in `parser` ("native" or "python").
"""

from __future__ import annotations

import gzip
from typing import Iterator, Optional

import numpy as np

NUM_DENSE = 13
NUM_SPARSE = 26
FEATURE_SHIFT = 44
_VAL_MASK = (1 << FEATURE_SHIFT) - 1
PARSERS = ("auto", "native", "python")


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def _hash_token(tok: str) -> int:
    """FNV-1a 32-bit over the token bytes (stable across runs/processes)."""
    h = 2166136261
    for c in tok.encode():
        h = ((h ^ c) * 16777619) & 0xFFFFFFFF
    return h


def parse_lines(lines, batch_size: int) -> Iterator[dict]:
    """The Python parser: full batches of `batch_size` lines; a final
    partial batch is dropped, as in the reference."""
    dense = np.zeros((batch_size, NUM_DENSE), np.float32)
    ids = np.zeros((batch_size, NUM_SPARSE), np.int64)
    label = np.zeros((batch_size,), np.float32)
    n = 0
    feat_base = np.arange(NUM_SPARSE, dtype=np.int64) << FEATURE_SHIFT
    for line in lines:
        parts = line.rstrip("\n").split("\t")
        if len(parts) < 1 + NUM_DENSE + NUM_SPARSE:
            parts = parts + [""] * (1 + NUM_DENSE + NUM_SPARSE - len(parts))
        label[n] = float(parts[0] or 0)
        for i in range(NUM_DENSE):
            v = parts[1 + i]
            x = float(v) if v else 0.0
            dense[n, i] = np.log1p(max(x, 0.0))
        for i in range(NUM_SPARSE):
            tok = parts[1 + NUM_DENSE + i]
            val = (_hash_token(tok) & _VAL_MASK) if tok else 0
            ids[n, i] = feat_base[i] | val
        n += 1
        if n == batch_size:
            yield {"dense": dense.copy(), "ids": ids.copy(), "label": label.copy()}
            n = 0


class CriteoStream:
    """Batches of Criteo TSV files. `parser="auto"` takes the native parser
    when it builds and the Python one otherwise; "native" raises when it
    does not build; "python" never builds it. `self.parser` says which one
    runs."""

    def __init__(self, paths, batch_size: int, host_id: int = 0, num_hosts: int = 1,
                 loop: bool = False, parser: str = "auto"):
        if parser not in PARSERS:
            raise ValueError(f"parser must be one of {PARSERS}, got {parser!r}")
        self.paths = [paths] if isinstance(paths, str) else list(paths)
        self.batch_size = batch_size
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.loop = loop
        if parser == "python":
            self.parser = "python"
        else:
            from meepoembedding_tpu_torch.data import criteo_native

            if parser == "native":
                criteo_native.load()  # raises with the build's error
                self.parser = "native"
            else:
                self.parser = "native" if criteo_native.available() else "python"

    def _lines(self):
        while True:
            for p in self.paths:
                with _open(p) as fh:
                    for i, line in enumerate(fh):
                        if i % self.num_hosts == self.host_id:
                            yield line
            if not self.loop:
                return

    def batches(self, steps: Optional[int] = None) -> Iterator[dict]:
        if self.parser == "native":
            from meepoembedding_tpu_torch.data import criteo_native

            it = criteo_native.parse_lines_native(self._lines(), self.batch_size)
        else:
            it = parse_lines(self._lines(), self.batch_size)
        if steps is None:
            yield from it
        else:
            for _, b in zip(range(steps), it):
                yield b


def write_synthetic_criteo(path: str, num_lines: int, seed: int = 0):
    """Tiny Criteo-format sample for tests (no dataset ships with the repo)."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as fh:
        for _ in range(num_lines):
            label = int(rng.random() < 0.25)
            dense = [
                str(int(rng.integers(0, 100))) if rng.random() > 0.1 else ""
                for _ in range(NUM_DENSE)
            ]
            cats = [
                f"{int(rng.integers(0, 1000)):08x}" if rng.random() > 0.05 else ""
                for _ in range(NUM_SPARSE)
            ]
            fh.write("\t".join([str(label)] + dense + cats) + "\n")


def write_synthetic_criteo_signal(
    path: str,
    num_lines: int,
    seed: int = 0,
    vocab_per_feature: int = 20000,
    zipf_s: float = 1.05,
    signal_scale: float = 0.9,
    stream_seed: int = None,
    interaction_scale: float = 0.0,
    interaction_rank: int = 4,
    interaction_pairs: int = 8,
):
    """Criteo-format stream with a planted CTR signal (the AUC-parity and
    model-zoo gates): each (feature, token) carries a hidden weight; label ~
    Bernoulli(sigmoid(mean of token weights + dense term - 1)). Tokens are
    drawn from a bounded Zipf(s) per feature.

    `stream_seed` (default: `seed`) draws the tokens, dense values and
    labels apart from the hidden weights, so seeds can vary the traffic
    while the planted task stays the same. `interaction_scale > 0` adds a
    latent-factor pairwise term: `interaction_pairs` feature pairs (f, g)
    carry hidden rank-`interaction_rank` token factors and add
    interaction_scale * <u_f[tok_f], u_g[tok_g]> to the logit, the structure
    dot-interaction models express and a concat-MLP must memorize."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(NUM_SPARSE, vocab_per_feature)).astype(np.float32)
    w *= signal_scale
    wd = rng.normal(size=(NUM_DENSE,)).astype(np.float32) * 0.1
    pairs, u_fac = [], None
    if interaction_scale > 0:
        fs = rng.permutation(NUM_SPARSE)
        pairs = [
            (int(fs[2 * p]), int(fs[2 * p + 1]))
            for p in range(min(interaction_pairs, NUM_SPARSE // 2))
        ]
        u_fac = rng.normal(
            size=(NUM_SPARSE, vocab_per_feature, interaction_rank)
        ).astype(np.float32) / np.sqrt(interaction_rank)
    rng = np.random.default_rng(seed if stream_seed is None else stream_seed)
    t = 1.0 - zipf_s
    with open(path, "w") as fh:
        for o in range(0, num_lines, 65536):
            n = min(65536, num_lines - o)
            u = rng.random((n, NUM_SPARSE))
            tok = (
                ((float(vocab_per_feature) ** t - 1.0) * u + 1.0) ** (1.0 / t)
            ).astype(np.int64)
            tok = np.minimum(tok, vocab_per_feature) - 1  # [n, 26]
            dense = rng.integers(0, 100, size=(n, NUM_DENSE))
            logit = (
                w[np.arange(NUM_SPARSE)[None, :], tok].mean(axis=1)
                + np.log1p(dense) @ wd
                - 1.0
            )
            for f, g in pairs:
                logit += interaction_scale * np.einsum(
                    "nr,nr->n", u_fac[f, tok[:, f]], u_fac[g, tok[:, g]]
                )
            label = (rng.random(n) < 1.0 / (1.0 + np.exp(-logit))).astype(int)
            lines = []
            for j in range(n):
                cats = [f"{int(x):08x}" for x in tok[j]]
                ints = [str(int(x)) for x in dense[j]]
                lines.append("\t".join([str(label[j])] + ints + cats))
            fh.write("\n".join(lines) + "\n")
