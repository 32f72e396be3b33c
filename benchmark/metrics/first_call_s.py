"""first_call_s: the host seconds of the process's first request or train step
(the program's first predict or step span: cuDNN plans, handles, the
allocator's growth, kernel libraries loaded), from its set-up snapshot: part of
setup_s."""

from benchmark.harness.stages import program


def read(out):
    snap = program(out, "program_setup")
    outer = "step" if out["kind"] == "train" else "predict"
    if snap is None or outer not in snap["spans"]:
        return None
    return snap["spans"][outer]["first_s"]
