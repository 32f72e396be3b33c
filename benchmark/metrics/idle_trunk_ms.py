"""idle_trunk_ms: the device's idle time per image while the host was in the
trunk and RPN stage (predict.trunk_rpn or step.trunk_rpn), in the traced
window, from the program's stage spans (benchmark/harness/stages.py)."""

from benchmark.harness.stages import per_image


def read(out):
    return per_image(out, "trunk_rpn", "idle_ms")
