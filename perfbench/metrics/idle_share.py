"""idle_share: the traced window less the union of the device's
operation intervals, over the window, in percent."""


def read(rec):
    tr = rec.trace
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (tr["window_s"] - tr["busy_s"]) / tr["window_s"]
