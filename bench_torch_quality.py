#!/usr/bin/env python3
"""The quality gates of the PyTorch + CUDA port, on one card, with the JAX
package's own criteria. Imports only the port.

    python3 bench_torch_quality.py [--device cuda]

AUC parity (after bench_auc_parity.py): on Criteo-format TSV with a planted
CTR signal (`write_synthetic_criteo_signal(seed=7, stream_seed=101 + s)`;
400K training plus 64K eval lines a stream seed s, 3 seeds, batch 2048),
read through `CriteoStream` (native parser, asserted) and `PrefetchStream`,
three trainers each learn DLRM (dim 16, bottom 64-16, top 128-64-1):

  dynamic  the port's `Trainer` on a 2^20-slot rowwise-AdaGrad table;
  policy   the same with frequency admission (threshold 2), LFU (freq < 2) /
           TTL (60 steps) eviction every 25 steps, at most 2^14 rows a pass,
           into a `HostKVStore` spill tier (admissions, evictions and spills
           must all be > 0);
  static   `baseline.StaticEmbeddingTrainer`, a 2^19-row hash-trick table.

Each is scored by held-out AUC (probe-only eval). parity holds when
|mean_dynamic - mean_static| <= 2 * max(std_static, 1e-4) + 1e-3, and
policy_parity when the policy runs' mean does.

Int8 serving (after bench_serving_auc.py): the dynamic trainer of stream
seed 0 trains on its 400K lines and saves a checkpoint; a `ScoringService`
scores the held-out 64K lines from it twice, from the f32 table and with
`quantize="int8"`. int8_gate holds when |AUC_int8 - AUC_f32| < 1e-3.

Zoo differentiation (after bench_model_zoo.py): the interaction stream
(`interaction_scale=2.5`, rank 4, 6 pairs, 800 values a feature, signal 0.2;
192K + 32K lines) trains dlrm, deepfm, dcn and ctr_mlp (dim 16, 2^18
slots); differentiates when max(dlrm, deepfm, dcn) - ctr_mlp > 0.005.

The TSV files go to build/quality/ (git-ignored) and are removed at the
end. Prints progress on stderr and one JSON line on stdout: the gates'
numbers, the seconds each took, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from meepoembedding_tpu_torch.backends import HostKVStore
from meepoembedding_tpu_torch.baseline import StaticEmbeddingTrainer
from meepoembedding_tpu_torch.config import (
    ModelConfig,
    OptimizerConfig,
    PolicyConfig,
    RunConfig,
    TableConfig,
)
from meepoembedding_tpu_torch.data import CriteoStream, PrefetchStream
from meepoembedding_tpu_torch.data.criteo import NUM_SPARSE, write_synthetic_criteo_signal
from meepoembedding_tpu_torch.metrics import StreamingAUC
from meepoembedding_tpu_torch.serving import ScoringService
from meepoembedding_tpu_torch.table.layout import TableSpec
from meepoembedding_tpu_torch.tiering import SpillCodec
from meepoembedding_tpu_torch.train import Trainer

ROOT = Path(__file__).resolve().parent
DIM = 16


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def parse_args():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--batch", type=int, default=2048)
    p.add_argument("--parity-lines", type=int, default=400_000)
    p.add_argument("--parity-eval-lines", type=int, default=64_000)
    p.add_argument("--vocab", type=int, default=1 << 19, help="static baseline rows")
    p.add_argument("--zoo-lines", type=int, default=192_000)
    p.add_argument("--zoo-eval-lines", type=int, default=32_000)
    return p.parse_args()


def card_line(dev: torch.device) -> str:
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def model_cfg(kind: str = "dlrm") -> ModelConfig:
    return ModelConfig(kind=kind, num_dense_features=13, num_sparse_features=NUM_SPARSE,
                       embedding_dim=DIM, bottom_mlp=(64, DIM), top_mlp=(128, 64, 1),
                       num_cross_layers=3)


def batches(tsv: Path, batch: int, steps: int):
    stream = PrefetchStream(CriteoStream(str(tsv), batch_size=batch), depth=2)
    if stream.parser != "native":
        raise AssertionError(f"CriteoStream parses with {stream.parser!r}, not native")
    return stream.batches(steps)


def train_eval(tr, it, train_steps: int, eval_steps: int, maintenance_every: int = 0) -> float:
    """Train `train_steps` batches of `it`, then return the held-out AUC of
    the next `eval_steps`."""
    for i in range(train_steps):
        tr.train_step(next(it))
        if maintenance_every and (i + 1) % maintenance_every == 0:
            tr.maintenance()
    auc = StreamingAUC()
    for _ in range(eval_steps):
        b = next(it)
        auc.update(tr.eval_step(b)["logits"], torch.from_numpy(b["label"]))
    return auc.compute()


def rowwise(lr: float = 0.05) -> OptimizerConfig:
    return OptimizerConfig(kind="rowwise_adagrad", learning_rate=lr)


def parity_gate(args, dev, root: Path) -> dict:
    b = args.batch
    train_steps, eval_steps = args.parity_lines // b, args.parity_eval_lines // b
    total = args.parity_lines + args.parity_eval_lines
    policy_table = TableConfig(
        dim=DIM, capacity=1 << 20, optimizer=rowwise(),
        policy=PolicyConfig(admit_threshold=2, evict_policy="lfu_ttl", ttl_steps=60,
                            lfu_min_freq=2, max_evict_per_pass=1 << 14))
    runs = {"dynamic": [], "dynamic_policy": [], "static": []}
    for seed in range(args.seeds):
        tsv = root / f"parity-s{seed}.tsv"
        t0 = time.perf_counter()
        write_synthetic_criteo_signal(str(tsv), total, seed=7, stream_seed=101 + seed)
        log(f"parity: wrote {total} lines (stream seed {101 + seed}) in "
            f"{time.perf_counter() - t0:.1f} s")
        run = RunConfig(batch_size=b, steps=train_steps, seed=seed, dense_learning_rate=1e-3,
                        log_every=10**9)
        steps = train_steps + eval_steps

        tr = Trainer(run, TableConfig(dim=DIM, capacity=1 << 20, optimizer=rowwise()),
                     model_cfg(), device=dev)
        auc = train_eval(tr, batches(tsv, b, steps), train_steps, eval_steps)
        runs["dynamic"].append({"seed": seed, "train_auc": tr.auc.compute(), "eval_auc": auc,
                                "rows": int(tr.shard.cnt.sum())})
        log("dynamic", runs["dynamic"][-1])

        spill = HostKVStore(SpillCodec(TableSpec.from_config(policy_table)).width, 1 << 18)
        tr = Trainer(run, policy_table, model_cfg(), device=dev, spill=spill)
        auc = train_eval(tr, batches(tsv, b, steps), train_steps, eval_steps,
                         maintenance_every=25)
        c = tr.counters()
        row = {"seed": seed, "train_auc": tr.auc.compute(), "eval_auc": auc,
               "rows": int(tr.shard.cnt.sum()), "spilled_resident": len(spill),
               **{k: c[k] for k in ("denied", "evictions", "spills", "inserts", "drops")}}
        for k in ("denied", "evictions", "spills"):
            if row[k] <= 0:
                raise AssertionError(f"policy machinery idle: {k} = 0 ({row})")
        runs["dynamic_policy"].append(row)
        log("dynamic_policy", row)

        st = StaticEmbeddingTrainer(run, model_cfg(), vocab_size=args.vocab, table_lr=0.05,
                                    device=dev)
        auc = train_eval(st, batches(tsv, b, steps), train_steps, eval_steps)
        runs["static"].append({"seed": seed, "train_auc": st.auc.compute(), "eval_auc": auc})
        log("static", runs["static"][-1])
        tsv.unlink()

    d, p, s = (np.array([r["eval_auc"] for r in runs[k]])
               for k in ("dynamic", "dynamic_policy", "static"))
    bar = 2 * max(float(s.std()), 1e-4) + 1e-3
    return {
        "dynamic_mean": float(d.mean()), "dynamic_std": float(d.std()),
        "dynamic_policy_mean": float(p.mean()), "dynamic_policy_std": float(p.std()),
        "static_mean": float(s.mean()), "static_std": float(s.std()),
        "delta": float(d.mean() - s.mean()), "policy_delta_vs_static": float(p.mean() - s.mean()),
        "bar": bar,
        "parity": bool(abs(d.mean() - s.mean()) <= bar),
        "policy_parity": bool(abs(p.mean() - s.mean()) <= bar),
        "runs": runs,
    }


def int8_gate(args, dev, root: Path) -> dict:
    b = args.batch
    train_steps, eval_steps = args.parity_lines // b, args.parity_eval_lines // b
    tsv, ckpt = root / "int8.tsv", root / "int8-ckpt"
    write_synthetic_criteo_signal(str(tsv), args.parity_lines + args.parity_eval_lines, seed=7,
                                  stream_seed=101)
    run = RunConfig(batch_size=b, steps=train_steps, seed=0, dense_learning_rate=1e-3,
                    log_every=10**9)
    table = TableConfig(dim=DIM, capacity=1 << 20, optimizer=rowwise())
    tr = Trainer(run, table, model_cfg(), device=dev)
    it = batches(tsv, b, train_steps + eval_steps)
    for _ in range(train_steps):
        tr.train_step(next(it))
    tr.save_checkpoint(str(ckpt))
    held = [next(it) for _ in range(eval_steps)]
    del tr
    out = {"train_steps": train_steps, "eval_examples": eval_steps * b}
    for mode in ("none", "int8"):
        svc = ScoringService(str(ckpt), table, model_cfg(), quantize=mode, device=dev)
        auc = StreamingAUC()
        for h in held:
            p = svc.score(h["dense"], h["ids"]).astype(np.float64)
            auc.update(torch.from_numpy(np.log(p / (1 - p) + 1e-12)),
                       torch.from_numpy(h["label"]))
        out[f"auc_{'f32' if mode == 'none' else mode}"] = auc.compute()
        if mode == "int8":
            out["int8_table_bytes"] = svc.table.nbytes()
        log(f"int8 gate {mode}: eval AUC {auc.compute():.5f}")
        del svc
    out["delta"] = out["auc_int8"] - out["auc_f32"]
    out["int8_gate"] = bool(abs(out["delta"]) < 1e-3)
    tsv.unlink()
    return out


def zoo_gate(args, dev, root: Path) -> dict:
    b = args.batch
    train_steps, eval_steps = args.zoo_lines // b, args.zoo_eval_lines // b
    tsv = root / "zoo.tsv"
    t0 = time.perf_counter()
    write_synthetic_criteo_signal(str(tsv), args.zoo_lines + args.zoo_eval_lines, seed=11,
                                  vocab_per_feature=800, signal_scale=0.2,
                                  interaction_scale=2.5, interaction_rank=4,
                                  interaction_pairs=6)
    log(f"zoo: wrote {args.zoo_lines + args.zoo_eval_lines} lines in "
        f"{time.perf_counter() - t0:.1f} s")
    aucs = {}
    for kind in ("dlrm", "deepfm", "dcn", "ctr_mlp"):
        run = RunConfig(batch_size=b, steps=train_steps, seed=0, dense_learning_rate=1e-3,
                        log_every=10**9)
        tr = Trainer(run, TableConfig(dim=DIM, capacity=1 << 18, optimizer=rowwise()),
                     model_cfg(kind), device=dev)
        aucs[kind] = train_eval(tr, batches(tsv, b, train_steps + eval_steps), train_steps,
                                eval_steps)
        log(f"zoo {kind}: eval AUC {aucs[kind]:.5f}")
    gap = max(aucs["dlrm"], aucs["deepfm"], aucs["dcn"]) - aucs["ctr_mlp"]
    return {**aucs, "order": sorted(aucs, key=aucs.get, reverse=True),
            "interaction_gap_vs_mlp": float(gap), "differentiates": bool(gap > 0.005)}


def main() -> int:
    args = parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("bench_torch_quality: no CUDA device visible; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    root = ROOT / "build" / "quality"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    seconds = {}
    try:
        t0 = time.perf_counter()
        parity = parity_gate(args, dev, root)
        seconds["parity"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        int8 = int8_gate(args, dev, root)
        seconds["int8"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        zoo = zoo_gate(args, dev, root)
        seconds["zoo"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({
        "metric": "criteo_format_eval_auc_port",
        "parity": parity["parity"], "policy_parity": parity["policy_parity"],
        "differentiates": zoo["differentiates"], "int8_gate": int8["int8_gate"],
        "auc_parity": parity, "int8": int8, "zoo": zoo, "seconds": seconds,
        "device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
        "card": card_line(dev), "torch": torch.__version__,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
