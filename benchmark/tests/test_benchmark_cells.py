"""BENCHMARK.json against the benchmark contract, and every cell found by
name: its configuration, its mix and each metric's reader."""

from __future__ import annotations

import json
import re

import pytest

from benchmark.harness import cells
from benchmark.reference.detector import param_specs

BENCH = cells.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    # 2 + 14 runs a cell at run_seconds + 60 s, 2 x 90 s of compile a cell,
    # 1200 s spare: fits 43200 s with the full 24 cells
    assert 1200 + 24 * (14 * (BENCH["run_seconds"] + 60) + 180) \
        + 2 * (BENCH["run_seconds"] + 60) <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"train_img_per_s", "serve_img_per_s", "peak_mem_gib",
                        "setup_s"}
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] == 0.25


def test_per_layer_metrics_move_an_end_to_end_metric_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        target = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in target.get("workloads", [w])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(workload):
    spec = cells.resolve(workload)
    cell = spec["cell"]
    assert workload == f"{cell['config']}.{cell['traffic']}"
    assert cell["chips"] == 1
    assert spec["mix"]["kind"] in ("train_rcnn", "serve")
    assert "setup_s" in {m["name"] for m in spec["end_to_end"]}
    assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
    for m in spec["per_layer"] + spec["end_to_end"]:
        assert callable(cells.metric_reader(m["name"]))
    config = spec["config"]
    assert config["name"] == cell["config"]
    assert param_specs(config["arch"])


def test_configurations_state_what_they_cut():
    for c in BENCH["configs"]:
        data = json.loads((cells.ROOT / c["file"]).read_text())
        assert c["file"].startswith("benchmark/")
        assert c["reduced"] == []          # no depth or width cut
        assert data["source"] == c["source"]
        assert data["precision"] == "float32"


def test_weights_are_made_again_alike_from_the_seed():
    """The check makes the weights again from the seed once the program's
    copy is gone: two draws of one seed are equal, of two seeds not."""
    import torch

    from benchmark.harness.weights import make_weights
    config = json.loads((cells.ROOT / "benchmark" / "configs"
                         / "fpn_learn_nms.json").read_text())
    cpu = torch.device("cpu")
    a = make_weights(config, 2 ** 31 + 5, cpu)
    b = make_weights(config, 2 ** 31 + 5, cpu)
    c = make_weights(config, 2 ** 31 + 6, cpu)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["roi_pool_fc1.weight"], c["roi_pool_fc1.weight"])
