"""bwd_dev_ms: device time per image of the operations launched while the
step's thread was in the program's backward stage (step.backward), those of
autograd's own thread included, in the traced window, from the program's stage
spans (benchmark/harness/stages.py)."""

from benchmark.harness.stages import per_image


def read(out):
    return per_image(out, "backward", "dev_ms")
