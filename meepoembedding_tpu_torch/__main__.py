"""`python -m meepoembedding_tpu_torch <cmd>`: the port's command line
(`cli.py`)."""

import sys

from meepoembedding_tpu_torch.cli import main

if __name__ == "__main__":  # importing the module runs nothing
    sys.exit(main())
