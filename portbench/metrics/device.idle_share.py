"""device.idle_share: the share of the profiled window (whole batches)
in which the card ran no kernel, copy or set: 1 - the union of their
intervals over the window's length."""


def read(rec):
    tr = rec.trace
    if not tr or not tr["busy_s"]:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
