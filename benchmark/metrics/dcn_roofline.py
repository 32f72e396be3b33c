"""dcn_roofline: the least time of the deformable forward of an image
(drivers/train_e2e.py::dcn_least_s: res5's offset and deformable convs,
the head's two PSROI pools and its offset FC) over the device time an image
launched under the program's dcn.conv and dcn.pool spans, in %."""

from benchmark.harness.spans import dev_ms_per_image

SPANS = ("dcn.conv", "dcn.pool")


def read(out):
    dev = dev_ms_per_image(out, SPANS)
    if not dev or "dcn_least_s" not in out:
        return None
    return 100.0 * out["dcn_least_s"] * 1e3 / dev
