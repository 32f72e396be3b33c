"""host_reads_per_img: the program's deliberate host reads of device data (its
host_read.* counters, relation_tpu_torch/utils/trace.py) in the stage
window (benchmark/harness/stages.py::window) per image."""

from benchmark.harness.stages import images, program


def read(out):
    snap = program(out)
    if snap is None:
        return None
    reads = sum(v for k, v in snap["counters"].items()
                if k.startswith("host_read."))
    return reads / images(out)
