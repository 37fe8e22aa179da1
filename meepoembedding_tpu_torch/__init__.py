"""PyTorch + CUDA port of the dynamic embedding engine (serving, training,
the table lifecycle, the Criteo input path, the model zoo, the embed API,
table groups, the row- and column-sharded layers and the command line).

`meepoembedding_tpu/` (JAX, TPU) is the reference; this package reproduces
its serving path (checkpoint restore into a hash table, probe-only lookups,
scoring, int8 tables, two-tower retrieval), its training path
(insert-on-miss lookups, the sparse optimizers, every model kind of its
zoo, the differentiable `embed` pair), its table lifecycle, its groups of
heterogeneous tables, its Criteo input path, and its row-sharded and
column-sharded training and serving over `torch.distributed` for an
NVIDIA H100. Plain tensor code is
PyTorch; the four row kernels the paths run are hand-written CUDA
(`csrc/`), built with `nvcc` at first use. CPU tensors take each kernel's
plain PyTorch version, which is how the tests run on machines without a
card.

Entry points take `device=` (default "cuda") and raise when no card is
visible:

  >>> from meepoembedding_tpu_torch import ScoringService, TableConfig, ModelConfig
  >>> svc = ScoringService("/path/to/ckpt", TableConfig(dim=32), ModelConfig())
  >>> svc.score(dense, ids)   # [B, 13] f32, [B, 26] int64 -> [B] probabilities
  >>> tr = Trainer(RunConfig(), TableConfig(dim=32), ModelConfig())
  >>> tr.train_step({"dense": dense, "ids": ids, "label": label})   # {"loss": ...}
  >>> init_distributed("gloo", "file:///tmp/store", rank, 4, device="cpu")
  >>> st = ShardedTrainer(RunConfig(), TableConfig(dim=32), ModelConfig(), device="cpu")
  >>> st.train_step(rank_rows)   # each rank passes its own rows of the batch

The command line (`cli.py`) has the reference's subcommands and flags, plus
`--device {cuda,cpu}`; installed, it is `meepo-torch`:

  python -m meepoembedding_tpu_torch train --data synthetic --set run.steps=100
  python -m meepoembedding_tpu_torch serve --ckpt /path/to/ckpt --http 8080
"""

from meepoembedding_tpu_torch.config import (  # noqa: F401
    ModelConfig,
    OptimizerConfig,
    PolicyConfig,
    RunConfig,
    TableConfig,
)
from meepoembedding_tpu_torch.parallel.mesh import init_distributed, make_mesh  # noqa: F401
from meepoembedding_tpu_torch.parallel.trainer import ShardedTrainer  # noqa: F401
from meepoembedding_tpu_torch.serving import ScoringService, make_http_server  # noqa: F401
from meepoembedding_tpu_torch.serving_sharded import ShardedScoringService  # noqa: F401
from meepoembedding_tpu_torch.table.runtime import DynamicEmbeddingTable  # noqa: F401
from meepoembedding_tpu_torch.train import Trainer  # noqa: F401
