"""host_reads_per_img: the program's deliberate host reads of device data (its
host_read.* counters, relation_tpu_torch/utils/trace.py) in the traced window
per image."""

from benchmark.harness.stages import program


def read(out):
    snap = program(out)
    if snap is None:
        return None
    reads = sum(v for k, v in snap["counters"].items()
                if k.startswith("host_read."))
    return reads / out["trace"]["images"]
