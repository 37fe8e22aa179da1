"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper dispatches by the device of the tensors it is given: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel (built at
first use by `_build`) or the wrapper raises. There is no fallback from the
kernel to the plain version. Each kernel source counts its launches in a
plain integer attribute of its main wrapper, `<wrapper>.launches`
(`segment_sum` and `segment_sum_gather`, its form that reads the rows of
any source, count their two kernels in `row_merge_add.launches`,
`row_scatter_set_multi` in `row_scatter_set.launches`, `row_gather_multi`
in `row_gather.launches`). `row_block_copy` holds the random-row block
gather and scatter of the DMA probe (`row_block_gather.launches`,
`row_block_scatter.launches`). `bucket_probe` is the table's whole probe,
the hash, every round and the first-lane match, in one launch
(`bucket_probe.launches`; its plain version `bucket_probe_plain`).
"""

from meepoembedding_tpu_torch.kernels.bucket_probe import (  # noqa: F401
    bucket_probe,
    bucket_probe_plain,
)
from meepoembedding_tpu_torch.kernels.row_block_copy import (  # noqa: F401
    row_block_gather,
    row_block_gather_plain,
    row_block_scatter,
    row_block_scatter_plain,
)
from meepoembedding_tpu_torch.kernels.row_gather import (  # noqa: F401
    row_gather,
    row_gather_multi,
    row_gather_multi_plain,
    row_gather_plain,
)
from meepoembedding_tpu_torch.kernels.row_merge_add import (  # noqa: F401
    row_merge_add,
    row_merge_add_plain,
    segment_size,
    segment_sum,
    segment_sum_gather,
)
from meepoembedding_tpu_torch.kernels.row_scatter_add import (  # noqa: F401
    row_scatter_add,
    row_scatter_add_plain,
)
from meepoembedding_tpu_torch.kernels.row_scatter_set import (  # noqa: F401
    row_scatter_set,
    row_scatter_set_multi,
    row_scatter_set_multi_plain,
    row_scatter_set_plain,
)
