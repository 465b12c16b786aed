"""digital_share: device time in every operation but B1's (attention,
the experts and router, norms, the logits, the drive's elementwise
passes) over the traced window, in percent."""


def read(rec):
    tr = rec.trace
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (tr["device_s"] - tr["b1_s"]) / tr["window_s"]
