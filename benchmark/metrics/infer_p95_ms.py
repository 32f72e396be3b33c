"""infer_p95_ms: the 95th percentile (nearest rank) of the host-clock time
from sending a request to its detections on the host, over every request
completed in the untraced window."""

import math


def read(out):
    lat = out.get("latency_ms")
    if not lat:
        return None
    return sorted(lat)[max(0, math.ceil(0.95 * len(lat)) - 1)]
