"""proposals_dev_ms: device time per image of the operations launched while the
host was in the program's proposal stage (predict.proposals: decode, top-k,
sort, the NMS kernel), in the traced window, from the program's stage spans
(benchmark/harness/stages.py)."""

from benchmark.harness.stages import per_image


def read(out):
    return per_image(out, "proposals", "dev_ms")
