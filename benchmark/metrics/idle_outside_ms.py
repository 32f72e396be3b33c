"""idle_outside_ms: the device's idle time per image while no stage of the
program was open on any thread (the caller's code, such as a client's copy of
the detections to the host), in the traced window, from the program's stage
spans (benchmark/harness/stages.py)."""

from benchmark.harness.stages import per_image


def read(out):
    return per_image(out, "outside", "idle_ms")
