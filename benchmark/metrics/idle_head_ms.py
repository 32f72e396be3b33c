"""idle_head_ms: the device's idle time per image while the host was in the ROI
head stage (predict.head: pooling, FCs, relation modules), in the traced
window, from the program's stage spans (benchmark/harness/stages.py)."""

from benchmark.harness.stages import per_image


def read(out):
    return per_image(out, "head", "idle_ms")
