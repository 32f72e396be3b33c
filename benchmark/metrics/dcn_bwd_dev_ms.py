"""dcn_bwd_dev_ms: device time per image of the operations launched under
the deformable conv's backward spans (dcn.conv_bwd: dw, the column
gradient and the offset gradient; dcn.col2im: dx), which the program opens
on autograd's thread, in the stage window (benchmark/harness/spans.py);
None where the program opens neither."""

from benchmark.harness.spans import dev_ms_per_image

SPANS = ("dcn.conv_bwd", "dcn.col2im")


def read(out):
    return dev_ms_per_image(out, SPANS)
