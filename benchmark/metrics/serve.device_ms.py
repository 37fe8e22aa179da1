"""serve.device_ms: device time a request of `ScoringService.score` (the
probe-only lookup and the tower's forward)."""


def read(r):
    return r.layer_ms_per_unit("serve")
