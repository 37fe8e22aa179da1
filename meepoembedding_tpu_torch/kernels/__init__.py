"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper dispatches by the device of the tensors it is given: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel (built at
first use by `_build`) or the wrapper raises. There is no fallback from the
kernel to the plain version. Each wrapper counts its launches in a plain
integer attribute, `<wrapper>.launches`.
"""

from meepoembedding_tpu_torch.kernels.row_gather import row_gather, row_gather_plain  # noqa: F401
from meepoembedding_tpu_torch.kernels.row_scatter_set import (  # noqa: F401
    row_scatter_set,
    row_scatter_set_plain,
)
