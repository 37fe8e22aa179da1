"""table.device_ms: device time a training step of the operations launched
under the table layer (`instrument.RULES`: the dedup, `lookup_train`, the
gather to batch order and its segment-sum backward, the sparse update)."""


def read(r):
    return r.layer_ms_per_unit("table")
