"""attn_roofline: the least time of the relation modules' and the
learned-NMS attention's forward work (flops.attention_least_s) for the
traced window's images, over the device time of the kernels launched inside
their spans, in %."""


def read(out):
    t = out.get("trace")
    dev = t["span_device_s"].get("pb:attn", 0.0) if t else 0.0
    if dev <= 0 or not t["images"]:
        return None
    return 100.0 * out["attn_least_s"] * t["images"] / dev
