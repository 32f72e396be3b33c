"""col2im_roofline: the least time of the col2im work of the stage window's
images (drivers/train_e2e.py::col2im_least_s: the column gradient read
once and dx written once, or the corners' multiply-adds) over the device
time launched under the program's dcn.col2im span, in %."""

from benchmark.harness.spans import dev_ms_per_image


def read(out):
    dev = dev_ms_per_image(out, ("dcn.col2im",))
    if not dev or "col2im_least_s" not in out:
        return None
    return 100.0 * out["col2im_least_s"] * 1e3 / dev
