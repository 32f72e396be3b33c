"""setup_kernels_s: the host seconds of the set-up spent building (where a
library is missing) and loading the port's CUDA kernel libraries, from the
program's setup.kernels span in its set-up snapshot: part of setup_s."""

from benchmark.harness.stages import program


def read(out):
    snap = program(out, "program_setup")
    if snap is None or "setup.kernels" not in snap["spans"]:
        return None
    return snap["spans"]["setup.kernels"]["total_s"]
