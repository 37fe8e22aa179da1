"""The benchmark's harness: everything `run.py` drives, found by name.

A cell of `BENCHMARK.json` names a configuration (`configs/<name>.json`) and
a traffic mix (`traffic/<name>.json`); its own parameters (batch, rate,
first-sighting share, correctness limits) are in `cells/<workload>.json`, and
each per-layer metric is read by `metrics/<metric>.py`. Nothing here imports
the JAX package or the port's `bench` package.
"""
