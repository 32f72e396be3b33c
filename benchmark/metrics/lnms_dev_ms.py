"""lnms_dev_ms: device time per image of the kernels launched inside the span of
the learned-NMS head (learn_nms), in the traced window; the forward only."""


def read(out):
    t = out.get("trace")
    dev = t["span_device_s"].get("pb:learn_nms", 0.0) if t else 0.0
    if dev <= 0 or not t["images"]:
        return None
    return 1e3 * dev / t["images"]
