"""run.py end to end on the CPU at a tiny size with the kernels' plain
versions: the contract's last line with every metric named, the checks
last; the program's stages in a traced run; the faults it must catch; no
JAX anywhere."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.harness import cells
from benchmark.tests._util import ROOT, rehearse

BENCH = cells.load_benchmark()
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
HOST_PER_LAYER = ("mfu", "infer_p95_ms", "infer_ms", "host_syncs_per_img")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_end_to_end_line(workload):
    rc, result, err = rehearse(workload)
    assert rc == 0, err[-3000:]
    spec = cells.resolve(workload)
    assert set(result) >= {"correct", "attempted", "failed", "metrics",
                           "device", "checks"}
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    assert result["attempted"] > 0 and result["failed"] == 0
    for name, check in result["checks"].items():
        assert f"check {name}:" in err.strip().splitlines()[-len(result["checks"]):][
            list(result["checks"]).index(name)]
        assert set(check) == {"value", "limit"}


@pytest.mark.parametrize("workload", WORKLOADS[:1] + WORKLOADS[1:2])
def test_per_layer_line(workload):
    rc, result, err = rehearse(workload, trace=1)
    assert rc == 0, err[-3000:]
    spec = cells.resolve(workload)
    named = {m["name"] for m in spec["per_layer"]}
    assert set(result["metrics"]) <= named
    # a CPU run has no device trace: only the host's numbers are read
    for m in spec["per_layer"]:
        if m["name"].split(".")[0] in HOST_PER_LAYER:
            assert m["name"] in result["metrics"], m["name"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


# what a traced run adds to its summary from the program's registry
_SUMMARY = """
import json, sys
sys.path.insert(0, '.')
from benchmark import run
from benchmark.harness import stages
from relation_tpu_torch.utils import trace as registry
seen = []
stage_window = stages.window
def window(*a, **k):
    seen.append(registry.snapshot()["spans"])
    return stage_window(*a, **k)
stages.window = window
keep = []
rc = run.main(sys.argv[1:], keep=keep)
out = keep[0] if keep else {}
print(json.dumps({"rc": rc, "kind": out.get("kind"), "trace": out.get("trace"),
                  "program": out.get("program"),
                  "program_setup": out.get("program_setup"),
                  "before_stage_window": seen}))
"""
# read only on a card: the kernels are built, and the CUDA allocator counts,
# only there
CARD_ONLY = ("setup_kernels_s", "dev_allocs_per_img")
STAGED = [w for w in WORKLOADS if w in ("fpn_learn_nms.rcnn_b4",
                                        "flagship.serve_conc")]


@pytest.mark.parametrize("workload", STAGED)
def test_traced_run_reads_the_program_s_stages(workload):
    """A traced run enables the program's registry for its set-up and its
    stage window: its summary carries the stages of that window and the
    registry's snapshots, while the first traced window has no ``rn:``
    record; and every stage metric of the cell reads a number from them
    once the trace has device time (a CPU trace has none, and the readers
    then read nothing)."""
    p = subprocess.run(
        [sys.executable, "-c", _SUMMARY, "--workload", workload, "--seed",
         "3000000019", "--seconds", "1", "--trace", "1", "--rehearse"],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
        env=dict(__import__("os").environ, OMP_NUM_THREADS="2"))
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["rc"] == 0, p.stderr[-3000:]
    kind = got["kind"]
    outer = "step" if kind == "train" else "predict"
    stages = got["trace"]["stages"]["stages"]
    assert {outer, f"{outer}.input", f"{outer}.trunk_rpn"} <= set(stages)
    assert got["trace"]["stages"]["images"] >= 1
    # the registry recorded nothing between the set-up and the stage window
    assert got["before_stage_window"] == [{}]
    assert all(row["host_ms"] >= 0 for row in stages.values())
    assert got["program"]["spans"][outer]["count"] >= 1
    assert "setup.model" in got["program_setup"]["spans"]
    assert outer in got["program_setup"]["spans"]
    stage_metrics = [m["name"] for m in cells.resolve(workload)["per_layer"]
                     if m["source"] in ("program_span", "program_counter")]
    assert len(stage_metrics) == 12
    out = dict(got)
    assert all(cells.metric_reader(m)(out) is None for m in stage_metrics)
    out["trace"]["stages"]["busy_ms"] = 1.0
    for m in stage_metrics:
        value = cells.metric_reader(m)(out)
        if m.split(".")[0] in CARD_ONLY:
            assert value is None, m
        else:
            assert isinstance(value, float) and value >= 0, (m, value)


def test_training_step_agrees_with_the_reference():
    rc, result, err = rehearse("fpn_learn_nms.rcnn_b4")
    assert rc == 0 and result["correct"], err[-3000:]


def _faults():
    """Each cell with the faults its kind can have: a step that leaves its
    state unchanged and half the batch left out (training), an answer
    altered where it is produced (serving)."""
    out = []
    for w in WORKLOADS:
        kind = cells.resolve(w)["mix"]["kind"]
        faults = (("frozen_state", "half_batch") if kind.startswith("train")
                  else ("altered_answer",))
        out += [(w, f) for f in faults]
    return out


@pytest.mark.parametrize("workload,fault", _faults())
def test_fault_is_caught(workload, fault):
    rc, result, err = rehearse(workload, "--fault", fault)
    assert rc == 0, err[-3000:]
    assert result["correct"] is False, result["checks"]


def test_no_jax_module_is_loaded():
    code = ("import sys, runpy; sys.argv = ['run.py', '--workload', "
            f"'{WORKLOADS[0]}', '--seed', '5', '--seconds', '0.5', "
            "'--rehearse'];\n"
            "try:\n    runpy.run_path('benchmark/run.py', run_name='__main__')\n"
            "except SystemExit:\n    pass\n"
            "bad = sorted({n.split('.')[0] for n in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'relation_tpu'})\n"
            "print('FORBIDDEN', bad)")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert "FORBIDDEN []" in p.stdout, p.stdout[-2000:] + p.stderr[-2000:]


REFERENCES = sorted(p.stem for p in (ROOT / "benchmark" / "reference").glob("*.py"))


@pytest.mark.parametrize("module", REFERENCES)
def test_reference_imports_nothing_of_the_program(module):
    name = ("benchmark.reference" if module == "__init__"
            else f"benchmark.reference.{module}")
    code = ("import sys; sys.path.insert(0, '.'); "
            f"import {name}, benchmark.harness.flops, benchmark.harness.compare; "
            "print(sorted({n.split('.')[0] for n in sys.modules} & "
            "{'relation_tpu_torch', 'relation_tpu', 'jax', 'jaxlib', 'flax'}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.stdout.strip() == "[]", p.stdout + p.stderr


def test_no_result_without_a_card():
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        WORKLOADS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
