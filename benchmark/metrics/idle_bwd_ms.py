"""idle_bwd_ms: the device's idle time per image while the host was in the
step's backward stage (step.backward), in the traced window, from the program's
stage spans (benchmark/harness/stages.py)."""

from benchmark.harness.stages import per_image


def read(out):
    return per_image(out, "backward", "idle_ms")
