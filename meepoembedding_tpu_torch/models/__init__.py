from meepoembedding_tpu_torch.models.dlrm import DLRM  # noqa: F401


def build_model(cfg, generator=None):
    """The model of `cfg.kind`. Only DLRM is ported; the other kinds of the
    reference's zoo wait for their slice (ROADMAP.md, queue 1, 'Model zoo')."""
    if cfg.kind == "dlrm":
        return DLRM(cfg, generator=generator)
    raise NotImplementedError(
        f"model kind {cfg.kind!r} is not ported yet (ROADMAP.md, queue 1, 'Model zoo')"
    )
