"""The port's model zoo (port of `meepoembedding_tpu/models/__init__.py`)."""

from meepoembedding_tpu_torch.models.bst import BST  # noqa: F401
from meepoembedding_tpu_torch.models.ctr_mlp import CtrMlp  # noqa: F401
from meepoembedding_tpu_torch.models.dcn import DCNv2  # noqa: F401
from meepoembedding_tpu_torch.models.deepfm import DeepFM  # noqa: F401
from meepoembedding_tpu_torch.models.din import DIN  # noqa: F401
from meepoembedding_tpu_torch.models.dlrm import DLRM  # noqa: F401
from meepoembedding_tpu_torch.models.two_tower import TwoTower  # noqa: F401

KINDS = {"dlrm": DLRM, "ctr_mlp": CtrMlp, "dcn": DCNv2, "deepfm": DeepFM,
         "two_tower": TwoTower, "din": DIN, "bst": BST}


def build_model(cfg, generator=None):
    """The model of `cfg.kind`, its weights drawn from `generator` (a CPU
    torch.Generator; the global generator when None)."""
    if cfg.kind not in KINDS:
        raise ValueError(f"unknown model kind: {cfg.kind}")
    return KINDS[cfg.kind](cfg, generator=generator)
