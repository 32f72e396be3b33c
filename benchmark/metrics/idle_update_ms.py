"""idle_update_ms: the device's idle time per image while the host was in the
step's update stage (step.update: the optimizer's update, the gradients
cleared), in the traced window, from the program's stage spans
(benchmark/harness/stages.py)."""

from benchmark.harness.stages import per_image


def read(out):
    return per_image(out, "update", "idle_ms")
