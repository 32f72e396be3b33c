"""setup_model_s: the host seconds of the set-up spent building the model
(core/trainer.py::build_model), from the program's setup.model span in its set-
up snapshot: part of setup_s."""

from benchmark.harness.stages import program


def read(out):
    snap = program(out, "program_setup")
    if snap is None or "setup.model" not in snap["spans"]:
        return None
    return snap["spans"]["setup.model"]["total_s"]
