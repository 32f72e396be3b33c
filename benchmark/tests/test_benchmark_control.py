"""The control of each cell's correctness check: the plain reference one
precision below the configuration's (TF32 for float32) must come out not
correct by the cell's limits, at the cell's own size, on one seed
(benchmark/tools/control.py reads more). TF32 exists only on the card, so
this runs there."""

from __future__ import annotations

import pytest

from benchmark.harness import cells
from benchmark.tools import control

WORKLOADS = [w["name"] for w in cells.load_benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("the control computes in TF32, which only an NVIDIA card has")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_a_limit(card, workload):
    spec = cells.resolve(workload)
    config, mix = spec["config"], spec["mix"]
    if cells.driver(mix["kind"]).KIND == "train":
        got = control.train_readings(config, mix, 7, card)
        limits = config["limits"]["train"]
    else:
        got = control.serve_readings(config, mix, 7, card)
        limits = config["limits"]["serve"]
    assert any(got[k] > limits[k] for k in limits if k in got), got
