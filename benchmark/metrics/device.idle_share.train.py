"""device.idle_share.train: the share of the traced training window in which
no operation ran on the device."""


def read(r):
    return r.idle_pct()
