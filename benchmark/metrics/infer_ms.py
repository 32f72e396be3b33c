"""infer_ms: the mean host-clock time from sending a request to its
detections on the host, over every request completed in the untraced
window."""


def read(out):
    lat = out.get("latency_ms")
    if not lat:
        return None
    return sum(lat) / len(lat)
