"""mfu: the model's operations per image (counted from the configuration's
shapes, benchmark/harness/flops.py) times the images of the untraced window,
over the window and the chip's float32 peak (TF32 off: the precision every
configuration states), in %."""

from benchmark.harness.flops import PEAK_F32


def read(out):
    if "flops_per_image" not in out or out["window_s"] <= 0 or out["images"] <= 0:
        return None
    rate = out["flops_per_image"] * out["images"] / out["window_s"]
    return 100.0 * rate / PEAK_F32
