"""run.py end to end on the CPU at a tiny size with the kernels' plain
versions: the contract's last line with every metric named, the checks
last; the faults it must catch; no JAX anywhere."""

from __future__ import annotations

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


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.'); "
            "import benchmark.reference.detector, benchmark.harness.flops; "
            "print(sorted({n.split('.')[0] for n in sys.modules} & "
            "{'relation_tpu_torch', 'relation_tpu', 'jax'}))")
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
