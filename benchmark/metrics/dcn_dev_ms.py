"""dcn_dev_ms: device time per image of the operations launched under the
program's deformable forward spans (dcn.conv: res5's offset convs and
deformable convs; dcn.pool: the head's two deformable PSROI pools and its
offset FC), in the stage window (benchmark/harness/spans.py); None where
the program opens neither."""

from benchmark.harness.spans import dev_ms_per_image

SPANS = ("dcn.conv", "dcn.pool")


def read(out):
    return dev_ms_per_image(out, SPANS)
