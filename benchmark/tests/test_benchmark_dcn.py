"""The deformable configuration's cell, ``dcn_learn_nms.train_b4``, on the
CPU: it resolves to its own new files (the ``dcn`` reference, the
``train_e2e`` driver, the ``train_b4`` mix); a traced rehearsal carries the
program's deformable spans, whose readers read nothing on the CPU and a
number once the stage window has device time; the operation counts and
the two least times equal hand counts; the END2END control reads the
cell's four numbers. Its result line, its faults and its
reference's imports are checked with every cell's
(test_benchmark_runs.py)."""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from benchmark.harness import cells, flops
from benchmark.reference import dcn, detector
from benchmark.tests._util import ROOT
from benchmark.tests.test_benchmark_cells import check_cell
from benchmark.tests.test_benchmark_runs import _SUMMARY

CELL = "dcn_learn_nms.train_b4"
NEW = ("dcn_dev_ms.train", "dcn_bwd_dev_ms.train", "col2im_roofline.train",
       "dcn_roofline.train")


def _config(name):
    return json.loads((cells.ROOT / "benchmark" / "configs"
                       / f"{name}.json").read_text())


def test_the_cell_resolves_to_its_own_files():
    spec = check_cell(CELL)
    assert spec["reference"].__file__ == str(cells.ROOT / "benchmark" / "reference"
                                             / "dcn.py")
    assert spec["mix"]["kind"] == "train_e2e"
    driver = cells.driver("train_e2e")
    assert driver.__file__ == str(cells.ROOT / "benchmark" / "harness" / "drivers"
                                  / "train_e2e.py")
    assert driver.KIND == "train"
    names = {m["name"] for m in spec["per_layer"]}
    assert set(NEW) <= names
    # every .train metric of the accepted cells is reported here too
    bench = cells.load_benchmark()
    assert {m["name"] for m in bench["per_layer"]
            if m["name"].endswith(".train")} == names
    assert {m["name"] for m in spec["end_to_end"]} >= {"train_img_per_s", "setup_s"}
    config = spec["config"]
    assert config["reference"] == "dcn" and config["precision"] == "float32"
    scales = config["init"]["head_scale"]
    assert set(dcn.OFFSET_LAYERS) < set(scales)
    assert all(0 < scales[k] < 1 for k in dcn.OFFSET_LAYERS)


def test_traced_rehearsal_carries_the_deformable_spans():
    p = subprocess.run(
        [sys.executable, "-c", _SUMMARY, "--workload", CELL, "--seed",
         "3000000023", "--seconds", "1", "--trace", "1", "--rehearse"],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
        env=dict(__import__("os").environ, OMP_NUM_THREADS="2"))
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["rc"] == 0, p.stderr[-3000:]
    stages = got["trace"]["stages"]["stages"]
    assert {"dcn.conv", "dcn.pool", "dcn.conv_bwd", "dcn.col2im"} <= set(stages)
    assert {"dcn.conv.samples", "dcn.pool.samples"} <= set(got["program"]["counters"])
    out = dict(got)
    assert all(cells.metric_reader(m)(out) is None for m in NEW)
    out["trace"]["stages"]["busy_ms"] = 1.0
    for row, ms in (("dcn.conv", 3.0), ("dcn.pool", 1.0), ("dcn.conv_bwd", 2.0),
                    ("dcn.col2im", 0.5)):
        stages[row]["dev_ms"] = ms * out["trace"]["stages"]["images"]
    out["dcn_least_s"], out["col2im_least_s"] = 2e-4, 1e-4
    read = {m: cells.metric_reader(m)(out) for m in NEW}
    assert read["dcn_dev_ms.train"] == 4.0
    assert read["dcn_bwd_dev_ms.train"] == 2.5
    assert abs(read["dcn_roofline.train"] - 5.0) < 1e-9
    assert abs(read["col2im_roofline.train"] - 20.0) < 1e-9


def test_the_deformable_operations_by_hand():
    """Against the flagship (the same detector with a plain dilated res5
    and a ROIAlign head): a request adds the three offset convs (72
    channels, 3x3 over 512, at 38x64) and the offset FC (12544 -> 98 over
    300 ROIs); a train step adds their backward too (the offset convs' dW
    and dX, the FC's dW: its input, a pool, takes no gradient through a
    product). The deformable conv's products are the plain conv's."""
    c, f = _config("dcn_learn_nms"), _config("flagship")
    hw = 38 * 64
    offset_convs = 3 * 2 * hw * 72 * 512 * 9
    assert dcn.serve_flops(c) - detector.serve_flops(f) == (
        offset_convs + 2 * 300 * 12544 * 98)
    R, G = 300, 16
    P = flops.meta_params(detector.param_specs(f["arch"]),
                          lambda n: detector.trainable(n, f["train"]["fixed_params"]))
    info = torch.tensor([608, 1024, 1.0], device="meta")

    def plain():
        outs = detector.trunk(P, torch.empty((1, 3, 608, 1024), device="meta"),
                              False, 2)
        cls, bb = detector.rpn_head(P, outs[4])
        feat = detector._conv(P, "conv_new_1", outs[5])
        pooled, rois = detector._head_inputs(R + G)
        s, b, fc2 = detector.head(P, ("fc_new_1", "fc_new_2"), pooled, rois, R)
        m, _, _ = detector.learn_nms(P, s[:R], b[:R], rois[:R], fc2[:R], info,
                                     100, f["arch"]["bbox_means"],
                                     f["arch"]["bbox_stds"])
        sum(o.sum() for o in (cls, bb, feat, s, b, m)).backward()
    assert dcn.train_flops(c, R, G) - flops.count_flops(plain) == (
        3 * offset_convs + 2 * 2 * (R + G) * 12544 * 98)


def test_the_least_times_by_hand():
    from benchmark.harness.drivers import train_e2e
    c = _config("dcn_learn_nms")
    hw, R = 38 * 64, 316
    conv = max(2 * hw * 9 * 512 * 584 / 495e12,
               4 * (2 * hw * 512 + hw * 72 + 9 * 512 * 584) / 3.35e12)
    pool0 = max(2 * R * 49 * 16 * 4 * 256 / 67e12,
                4 * (hw * 256 + 4 * R + 49 * 256 * R) / 3.35e12)
    pool1 = max(2 * R * 49 * 16 * 4 * 256 / 67e12,
                4 * (hw * 256 + 4 * R + 98 * R + 49 * 256 * R) / 3.35e12)
    fc = max(2 * R * 12544 * 98 / 495e12,
             4 * (R * 12544 + 12544 * 98 + 98 * R) / 3.35e12)
    want = 3 * conv + pool0 + pool1 + fc
    assert abs(train_e2e.dcn_least_s(c, R) - want) <= 1e-12 * want
    col = max(2 * hw * 9 * 4 * 512 / 67e12, 4 * (hw * 9 * 512 + hw * 512) / 3.35e12)
    assert abs(train_e2e.col2im_least_s(c) - 3 * col) <= 1e-12 * col
    # at the cell's shape: the convs' products, the pools' taps and the
    # column gradient's bytes bound them
    assert conv == 2 * hw * 9 * 512 * 584 / 495e12
    assert col == 4 * (hw * 9 * 512 + hw * 512) / 3.35e12


def test_the_end2end_control_reads_the_cell_s_numbers():
    """tools/control_e2e.py at the rehearsal size: on the CPU both sides
    compute in float32, so every reading is within the cell's limits."""
    from benchmark.harness.common import rehearsal
    from benchmark.tools import control_e2e
    spec = cells.resolve(CELL)
    config, mix = rehearsal(spec["config"], spec["mix"])
    got = control_e2e.readings(config, mix, spec["reference"], 3,
                               torch.device("cpu"))
    limits = config["limits"]["train"]
    assert set(limits) <= set(got)
    assert all(got[k] <= limits[k] for k in limits), got
