"""Operations and bytes of a cell's work, counted from the configuration's
shapes, and the chip's peaks.

The model's operations are counted once by running the plain reference on
the ``meta`` device under ``torch.utils.flop_counter.FlopCounterMode`` (a
multiply-add counts 2; products only: convolutions, matrix products and
einsums). A train step counts its forward and the backward of what trains,
the same work whatever implements it. The attention's least time (for the
``attn_roofline`` metrics) counts the relation modules' and the learned-NMS
attention's products and the bytes they must read and write once.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import detector as ref

# NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W)
PEAK_F32 = 67e12          # float32 outside the tensor cores (TF32 off)
PEAK_TF32 = 495e12        # the fastest rate for float32-accurate products
HBM_BYTES_S = 3.35e12


def _meta_params(config, train: bool):
    P = {}
    for name, shape in ref.param_specs(config["arch"]):
        t = torch.empty(shape, device="meta")
        if train and ref.trainable(name, config["train"]["fixed_params"]):
            t.requires_grad_(True)
        P[name] = t
    return P


def _count(fn) -> int:
    with FlopCounterMode(display=False) as mode:
        fn()
    return int(mode.get_total_flops())


def _head_inputs(R):
    pooled = torch.empty((R, 7, 7, 256), device="meta")
    rois = torch.empty((R, 4), device="meta")
    return pooled, rois


def serve_flops(config) -> int:
    """Operations of one request: trunk, RPN, head over the proposals, the
    learned-NMS head over every class."""
    a, t = config["arch"], config["test"]
    H, W = config["images"]["bucket"]
    P = _meta_params(config, False)
    R, F_ = int(t["rpn_post_nms_top_n"]), int(t["first_n"])
    info = torch.tensor([H, W, 1.0], device="meta")
    fc = (("roi_pool_fc1", "roi_pool_fc2") if a["trunk"] == "fpn"
          else ("fc_new_1", "fc_new_2"))

    def run():
        x = torch.empty((1, 3, H, W), device="meta")
        outs = ref.trunk(P, x, a["trunk"] == "fpn")
        if a["trunk"] == "fpn":
            for lvl in ref.fpn_neck(P, outs).values():
                ref.rpn_head(P, lvl)
        else:
            ref.rpn_head(P, outs[4])
            ref._conv(P, "conv_new_1", outs[5])
        pooled, rois = _head_inputs(R)
        cls, box, fc2 = ref.head(P, fc, pooled, rois, R)
        ref.learn_nms(P, cls, box, rois, fc2, info, F_, a["bbox_means"],
                      a["bbox_stds"])
    with torch.no_grad():
        return _count(run)


def train_flops(config, rois_per_image: int, gt_per_image: int) -> int:
    """Operations of one image of the FPN RCNN step and the backward of
    every trainable leaf's path: trunk and neck (no RPN: the step has no
    RPN loss), the head over the ROIs and ground truth and the learned-NMS
    branch over the first ``nongt`` rows."""
    a, tr = config["arch"], config["train"]
    H, W = config["images"]["bucket"]
    P = _meta_params(config, True)
    R = rois_per_image + gt_per_image
    nongt = min(int(tr["rpn_post_nms_top_n"]), rois_per_image)
    info = torch.tensor([H, W, 1.0], device="meta")

    def run():
        x = torch.empty((1, 3, H, W), device="meta")
        maps = list(ref.fpn_neck(P, ref.trunk(P, x, True, 2)).values())
        pooled, rois = _head_inputs(R)
        cls, box, fc2 = ref.head(P, ("roi_pool_fc1", "roi_pool_fc2"), pooled,
                                 rois, nongt)
        multi, _, _ = ref.learn_nms(P, cls[:nongt], box[:nongt], rois[:nongt],
                                    fc2[:nongt], info, int(tr["first_n"]),
                                    a["bbox_means"], a["bbox_stds"])
        loss = cls.sum() + box.sum() + multi.sum() + sum(v.sum() for v in maps)
        loss.backward()
    return _count(run)


def attention_least_s(config, R: int, K: int, first_n: int) -> float:
    """Least time of one image's attention forward: the two relation
    modules over R rows and K keys and the learned-NMS attention over
    ``first_n`` boxes of every class; per module the operations at
    PEAK_TF32 or the bytes of their inputs, weights and outputs (f32, each
    read or written once) at HBM_BYTES_S, whichever is larger."""
    C, G, D, F_ = int(config["arch"]["num_classes"]) - 1, 16, 1024, first_n
    rel_ops = 2 * (R * D * D + K * D * D + R * K * D + R * K * D * G
                   + R * G * D * 64 + R * K * 64 * G)
    rel_bytes = 4 * (2 * R * D + 4 * R * K + 2 * D * D + G * D * 64 + 64 * G)
    nms_ops = 2 * (2 * C * F_ * 128 * D + C * F_ * F_ * D + C * G * F_ * F_ * 128
                   + C * F_ * G * 128 * 8 + C * F_ * F_ * 64 * G)
    nms_bytes = 4 * (2 * C * F_ * 128 + 4 * C * F_ * F_ + 2 * 128 * D
                     + G * 128 * 8 + 64 * G)

    def least(ops, nbytes):
        return max(ops / PEAK_TF32, nbytes / HBM_BYTES_S)
    return 2 * least(rel_ops, rel_bytes) + least(nms_ops, nms_bytes)
