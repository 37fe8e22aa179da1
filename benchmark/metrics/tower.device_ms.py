"""tower.device_ms: device time a training step of the DLRM tower: its
forward and loss, its backward nodes and the dense Adam."""


def read(r):
    return r.layer_ms_per_unit("tower")
