"""The port's Trainer against the JAX package's on multi-hot [B, S, L] id
bags (sentinel-padded, mean combiner), at dims 8, 32 and 256, with the
tolerances of `_torch_train_parity.py`: integer planes and counters
exactly, floats within rtol 1e-5 / atol 1e-6. One-hot batches are in
`test_torch_train.py`."""

import pytest
import torch
from _torch_train_parity import run_trainer_case

torch.set_num_threads(1)

# (dim, bag length, sparse optimizer): the other kinds take the fallback
# that writes the inits first, then the generic update
CASES = [(8, 4, "adam"), (32, 3, "rowwise_adagrad"), (256, 3, "momentum")]


@pytest.mark.parametrize("dim,bag,kind", CASES, ids=[f"dim{d}-bag{b}-{k}" for d, b, k in CASES])
def test_trainer_matches_jax_on_bags(dim, bag, kind):
    run_trainer_case(dim, bag, kind, {})
