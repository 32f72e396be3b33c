"""The operation and byte counts against hand counts at small shapes, and
each cell's counts at its own shapes against those recorded before the
counts moved into the configuration's reference."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark.harness import cells, flops
from benchmark.reference import detector as ref

# (flops_per_image, attn_least_s) of each cell, as the harness counted them
# when harness/flops.py held the counts of both detectors
RECORDED = {"fpn_learn_nms.rcnn_b4": (1173896323072, 0.00010845188551111112),
            "flagship.serve_conc": (297929842688, 4.3273619393939395e-05),
            "fpn_learn_nms.serve_conc": (542712414208, 6.432457696969697e-05)}


def _config(name):
    return json.loads((cells.ROOT / "benchmark" / "configs"
                       / f"{name}.json").read_text())


def test_conv_and_linear_count_two_per_multiply_add():
    P = {"c.weight": torch.empty((8, 3, 3, 3), device="meta"),
         "d.weight": torch.empty((5, 7), device="meta"),
         "d.bias": torch.empty((5,), device="meta")}
    x = torch.empty((1, 3, 10, 12), device="meta")
    n = flops.count_flops(lambda: ref._conv(P, "c", x, 1, 1))
    assert n == 2 * 3 * 8 * 9 * 10 * 12
    n = flops.count_flops(lambda: ref._linear(P, "d", torch.empty((4, 7), device="meta")))
    assert n == 2 * 4 * 7 * 5


def test_relation_module_count():
    c = _config("flagship")
    P = flops.meta_params(ref.param_specs(c["arch"]))
    N, K = 6, 4
    x = torch.empty((N, 1024), device="meta")
    pos = torch.empty((4, N, K), device="meta")
    n = flops.count_flops(lambda: ref.relation(P, 1, x, pos))
    hand = 2 * (N * 1024 * 1024 + K * 1024 * 1024   # query, key
                + N * K * 1024                        # q k^T over 16 heads
                + N * K * 1024 * 16                   # attention x values
                + N * 16 * 1024 * 64                  # linear_out
                + N * K * 64 * 16)                    # geometric bias
    assert n == hand


def test_attention_least_time_by_hand():
    c = _config("flagship")
    R, K, F_ = 3, 2, 2
    C, G, D = 80, 16, 1024
    rel_ops = 2 * (R * D * D + K * D * D + R * K * D + R * K * D * G
                   + R * G * D * 64 + R * K * 64 * G)
    rel_bytes = 4 * (2 * R * D + 4 * R * K + 2 * D * D + G * D * 64 + 64 * G)
    nms_ops = 2 * (2 * C * F_ * 128 * D + C * F_ * F_ * D + C * G * F_ * F_ * 128
                   + C * F_ * G * 128 * 8 + C * F_ * F_ * 64 * G)
    nms_bytes = 4 * (2 * C * F_ * 128 + 4 * C * F_ * F_ + 2 * 128 * D
                     + G * 128 * 8 + 64 * G)
    want = (2 * max(rel_ops / flops.PEAK_TF32, rel_bytes / flops.HBM_BYTES_S)
            + max(nms_ops / flops.PEAK_TF32, nms_bytes / flops.HBM_BYTES_S))
    assert abs(flops.attention_least_s(c, R, K, F_) - want) <= 1e-12 * want


def test_stem_count_and_train_over_serve():
    c = _config("flagship")
    c["images"]["bucket"] = [64, 128]
    P = flops.meta_params(ref.param_specs(c["arch"]))
    x = torch.empty((1, 3, 64, 128), device="meta")
    n = flops.count_flops(lambda: torch.nn.functional.conv2d(
        x, P["c4.conv1.weight"], None, 2, 3))
    assert n == 2 * 3 * 64 * 49 * 32 * 64
    c = _config("fpn_learn_nms")
    c["images"]["bucket"] = [64, 128]
    serve = ref.serve_flops(c)
    train = ref.train_flops(c, 300, 16)
    # forward plus the backward of what trains (all but conv1 and res2):
    # more than twice, less than three times the forward
    assert 2 * serve < train < 3.2 * serve


@pytest.mark.parametrize("workload", sorted(RECORDED))
def test_cell_counts_equal_the_recorded(workload):
    spec = cells.resolve(workload)
    driver = cells.driver(spec["mix"]["kind"])
    got = driver.work_counts(spec["reference"], spec["config"], spec["mix"])
    assert got == RECORDED[workload]
    assert isinstance(got[0], int)
