"""device.idle_share.serve: the share of the traced serving window in which
no operation ran on the device (waits for due times included)."""


def read(r):
    return r.idle_pct()
