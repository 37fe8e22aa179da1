"""Data sources of the port (numpy; batches are dicts of arrays)."""

from meepoembedding_tpu_torch.data.criteo import CriteoStream  # noqa: F401
from meepoembedding_tpu_torch.data.prefetch import PrefetchStream  # noqa: F401
from meepoembedding_tpu_torch.data.synthetic import SyntheticConfig, SyntheticStream  # noqa: F401
