"""idle_rois_ms: the device's idle time per image while the host was in the
step's per-image ROI stage (step.rois: sampling and targets, head, losses,
learned-NMS branch), in the traced window, from the program's stage spans
(benchmark/harness/stages.py)."""

from benchmark.harness.stages import per_image


def read(out):
    return per_image(out, "rois", "idle_ms")
