"""idle_share: the share of the traced window in which no operation ran on
the device (1 - merged device busy time / window), in %."""


def read(out):
    t = out.get("trace")
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
