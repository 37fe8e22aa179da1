"""The measurement harnesses: ports of the reference's root scripts, each
run as `python -m meepoembedding_tpu_torch.bench.<name> [--device
cuda|cpu]` with the reference's `MEEPO_*` environment variables, defaults,
log lines (stderr) and JSON keys (the last stdout line), and each callable
in-process as `run(device=..., **knobs) -> dict`:

  headline          bench.py: ids/s of the dynamic step, vs_baseline and
                    vs_sol_unique against a static table
  phases            bench_phases.py: the step timed as prefixes
  stages            bench_stages.py: each stage of the step alone
  evict             bench_evict.py: an eviction pass, scan only and with exports
  ckpt_full         bench_ckpt_full.py: streamed save, elastic restore
  serving           bench_serving.py: scores/s and latency, f32, int8, sharded
  retrieval         bench_retrieval.py: index build rate, top-k latency
  sharded_overhead  bench_sharded_overhead.py: ShardedTrainer at S = 1
                    against the single-device step
  scaling           bench_scaling.py: weak scaling, one process a rank

`--device cuda` (the default) raises without a card.
"""
