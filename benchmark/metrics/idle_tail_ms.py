"""idle_tail_ms: the device's idle time per image while the host was in the
tail stage (predict.tail: learned NMS or classic NMS, and the top-k cut), in
the traced window, from the program's stage spans
(benchmark/harness/stages.py)."""

from benchmark.harness.stages import per_image


def read(out):
    return per_image(out, "tail", "idle_ms")
