"""BENCHMARK.json against the benchmark contract, and every cell found by
name: its configuration and that configuration's reference, its mix and the
mix kind's driver, and each metric's reader; a new configuration and a new
mix kind found the same way from files alone."""

from __future__ import annotations

import json
import re
import shutil
import textwrap

import pytest

from benchmark import reference
from benchmark.harness import cells, drivers

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


def check_cell(workload, root=cells.ROOT):
    """What every cell of a BENCHMARK.json under ``root`` has to resolve
    to: its configuration and the reference that configuration names (or
    the default), its mix and the driver of the mix's kind with that
    kind's interface, and a reader for each metric it reports."""
    spec = cells.resolve(workload, root)
    cell = spec["cell"]
    assert workload == f"{cell['config']}.{cell['traffic']}"
    assert cell["chips"] in (1, 4)
    driver = cells.driver(spec["mix"]["kind"], root)
    assert driver.KIND in drivers.INTERFACE
    for name in drivers.INTERFACE[driver.KIND]:
        assert callable(getattr(driver, name)), name
    assert "setup_s" in {m["name"] for m in spec["end_to_end"]}
    assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
    for m in spec["per_layer"]:
        assert m["name"].split(".", 1)[1:] in ([], [driver.KIND]), m["name"]
    for m in spec["per_layer"] + spec["end_to_end"]:
        assert callable(cells.metric_reader(m["name"], root))
    config = spec["config"]
    assert config["name"] == cell["config"]
    ref = spec["reference"]
    assert ref is cells.reference(config, root)
    own = config.get("reference", cells.DEFAULT_REFERENCE)
    assert ref.__file__ == str(root / "benchmark" / "reference" / f"{own}.py")
    assert ref.param_specs(config["arch"])
    for fn in reference.INTERFACE:
        assert callable(getattr(ref, fn)), fn
    return spec


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(workload):
    check_cell(workload)


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
    ref = cells.reference(config)
    cpu = torch.device("cpu")
    a = make_weights(ref, config, 2 ** 31 + 5, cpu)
    b = make_weights(ref, config, 2 ** 31 + 5, cpu)
    c = make_weights(ref, config, 2 ** 31 + 6, cpu)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["roi_pool_fc1.weight"], c["roi_pool_fc1.weight"])


def _checkout_with(tmp_path):
    """A copy of the benchmark's files with one more configuration, which
    names its own reference, and one more mix, of a kind of its own with
    its own driver, and a cell of the two: new files and entries only."""
    root = tmp_path / "checkout"
    shutil.copytree(cells.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads(json.dumps(BENCH))
    config = json.loads((cells.ROOT / "benchmark" / "configs"
                         / "flagship.json").read_text())
    config.update(name="toy", reference="toy_ref")
    (root / "benchmark" / "configs" / "toy.json").write_text(json.dumps(config))
    (root / "benchmark" / "reference" / "toy_ref.py").write_text(textwrap.dedent(
        """
        from benchmark.reference.detector import (  # noqa: F401
            calibration_outputs, predict, serve_flops, train_flops,
            train_steps, trainable)
        from benchmark.reference import detector

        def param_specs(arch):
            return detector.param_specs(arch) + [("toy.offset.weight", (8, 4, 3, 3))]
        """))
    (root / "benchmark" / "mixes" / "toy_mix.json").write_text(
        json.dumps({"kind": "toy_kind", "steps": 2}))
    (root / "benchmark" / "harness" / "drivers" / "toy_kind.py").write_text(
        textwrap.dedent(
            """
            KIND = "train"

            def run(ctx, t_start):
                specs = ctx["reference"].param_specs(ctx["config"]["arch"])
                return {"kind": KIND, "leaves": len(specs)}

            def build(ctx):
                raise NotImplementedError

            def work_counts(ref, config, mix):
                return ref.train_flops(config, 8, 2), 0.0
            """))
    bench["configs"].append({"name": "toy", "source": "https://example.org/toy",
                             "file": "benchmark/configs/toy.json", "reduced": [],
                             "why": "a configuration with its own reference"})
    bench["workloads"].append({"name": "toy.toy_mix", "config": "toy",
                               "traffic": "toy_mix", "chips": 1,
                               "why": "a mix with its own driver"})
    train = {m["name"] for m in BENCH["end_to_end"]
             if "fpn_learn_nms.rcnn_b4" in m.get("workloads", [])}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and (m["name"] in train
                                 or m["name"].endswith(".train")):
            m["workloads"].append("toy.toy_mix")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _benchmark_files():
    return {p: p.read_bytes() for p in cells.BENCH_DIR.rglob("*")
            if p.is_file() and not {"__pycache__", ".cache"} & set(p.parts)}


def test_a_configuration_and_a_mix_kind_of_their_own_are_files_only(tmp_path):
    before = _benchmark_files()
    root = _checkout_with(tmp_path)
    spec = cells.resolve("toy.toy_mix", root)
    ref = spec["reference"]
    assert ref.__file__ == str(root / "benchmark" / "reference" / "toy_ref.py")
    plain = cells.resolve(BENCH["workloads"][1]["name"], root)["reference"]
    assert (ref.param_specs(spec["config"]["arch"])[-1]
            == ("toy.offset.weight", (8, 4, 3, 3)))
    assert (len(ref.param_specs(spec["config"]["arch"]))
            == len(plain.param_specs(spec["config"]["arch"])) + 1)
    driver = cells.driver(spec["mix"]["kind"], root)
    out = driver.run({"reference": ref, "config": spec["config"]}, 0.0)
    assert out == {"kind": "train",
                   "leaves": len(plain.param_specs(spec["config"]["arch"])) + 1}
    with pytest.raises(FileNotFoundError, match="drivers/no_such_kind.py"):
        cells.driver("no_such_kind", root)
    # the benchmark's own files are as they were
    assert _benchmark_files() == before


def test_a_cell_with_its_own_reference_and_driver_passes_the_cell_checks(tmp_path):
    """The cell checks that every cell of BENCHMARK.json passes hold for a
    new cell whose configuration names its own reference and whose mix is
    of a kind of its own, with no file of the benchmark edited; a driver or
    a reference that lacks part of its interface is refused by name."""
    before = _benchmark_files()
    root = _checkout_with(tmp_path)
    spec = check_cell("toy.toy_mix", root)
    assert spec["config"]["reference"] == "toy_ref"
    for w in BENCH["workloads"]:
        check_cell(w["name"], root)
    assert _benchmark_files() == before
    lacking = root / "benchmark" / "harness" / "drivers" / "lacking.py"
    lacking.write_text('KIND = "serve"\n\ndef run(ctx, t_start):\n    return {}\n')
    with pytest.raises(AttributeError, match="work_counts.*summarise"):
        cells.driver("lacking", root)
    (root / "benchmark" / "reference" / "bare.py").write_text(
        "def param_specs(arch):\n    return []\n")
    with pytest.raises(AttributeError, match="trainable"):
        cells.reference({"name": "bare", "reference": "bare"}, root)
