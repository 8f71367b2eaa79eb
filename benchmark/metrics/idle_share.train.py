"""idle_share.train (%): the share of the traced window in which the card
ran nothing, 100 x (window - union of the device's activity) / window."""


def read(ctx):
    trace = ctx["trace"]
    if trace is None or trace["window_s"] <= 0:
        return None
    return 100.0 * (trace["window_s"] - trace["busy_s"]) / trace["window_s"]
