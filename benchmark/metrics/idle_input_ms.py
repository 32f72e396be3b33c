"""idle_input_ms: the device's idle time per image while the host was in the
program's input stage (predict.input or step.input: the copy to the device, the
uint8 pre-processing), in the traced window, from the program's stage spans
(benchmark/harness/stages.py)."""

from benchmark.harness.stages import per_image


def read(out):
    return per_image(out, "input", "idle_ms")
