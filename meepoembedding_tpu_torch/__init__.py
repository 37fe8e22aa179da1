"""PyTorch + CUDA port of the dynamic embedding engine (serving slice).

`meepoembedding_tpu/` (JAX, TPU) is the reference; this package reproduces
its serving path for an NVIDIA H100: checkpoint restore into a hash table,
probe-only lookups and DLRM scoring. Plain tensor code is PyTorch; the two
row kernels the path runs are hand-written CUDA (`csrc/`), built with `nvcc`
at first use. CPU tensors take each kernel's plain PyTorch version, which
is how the tests run on machines without a card.

Entry points take `device=` (default "cuda") and raise when no card is
visible:

  >>> from meepoembedding_tpu_torch import ScoringService, TableConfig, ModelConfig
  >>> svc = ScoringService("/path/to/ckpt", TableConfig(dim=32), ModelConfig())
  >>> svc.score(dense, ids)   # [B, 13] f32, [B, 26] int64 -> [B] probabilities
"""

from meepoembedding_tpu_torch.config import (  # noqa: F401
    ModelConfig,
    OptimizerConfig,
    PolicyConfig,
    TableConfig,
)
from meepoembedding_tpu_torch.serving import ScoringService, make_http_server  # noqa: F401
from meepoembedding_tpu_torch.table.runtime import DynamicEmbeddingTable  # noqa: F401
