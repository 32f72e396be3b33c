"""Where the time of the port's flagship inference goes, on one CUDA card.

    python3 -m relation_tpu_torch.tools.profile_flagship [--requests 3] [--trace out.json]

Builds the flagship of relation_tpu_torch (entry.py::flagship_cfg, weights
from init_params(seed=0)) on cuda:0, warms up, then:

1. stage split: host clock with torch.cuda.synchronize() around each stage
   (trunk + RPN head, proposals, ROI head with relations, learned NMS,
   detection tail) of one seeded 608x1024 request, median over --requests;
2. torch.profiler over --requests whole requests: device busy time (the
   sum of kernel times, overlaps merged) against the window's wall time,
   so the idle share, and the kernels ranked by device time.

Prints the card's name and power limit first. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--trace", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.predictor import _topk_detections, make_predict_fn
    from relation_tpu_torch.core.trainer import build_model
    from relation_tpu_torch.entry import BUCKET, flagship_cfg
    from relation_tpu_torch.models.learn_nms import merge_multi_score
    from relation_tpu_torch.models.rpn import generate_proposals
    from relation_tpu_torch.ops.anchors import generate_anchors

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    cfg = flagship_cfg()
    model = init_params(build_model(cfg, device=dev), seed=0)
    predict = make_predict_fn(model, cfg)
    H, W = BUCKET
    image = torch.tensor(np.random.RandomState(7).randn(12, H // 2, W // 2) * 40.0,
                         dtype=torch.float32, device=dev)
    im_info = torch.tensor([600.0, 1000.0, 1.667], device=dev)
    net, test = cfg.network, cfg.TEST
    stride = int(net.RPN_FEAT_STRIDE)
    anchors = torch.tensor(generate_anchors(stride, tuple(net.ANCHOR_RATIOS),
                                            tuple(net.ANCHOR_SCALES)),
                           dtype=torch.float32, device=dev)
    for _ in range(2):
        predict(image, im_info)
    torch.cuda.synchronize()

    stages = {k: [] for k in ("trunk+rpn", "proposals", "head", "learn_nms",
                              "dets", "total")}
    with torch.inference_mode():
        for _ in range(args.requests):
            t = [time.perf_counter()]

            def mark():
                torch.cuda.synchronize()
                t.append(time.perf_counter())
            feat, rpn_cls, rpn_bbox = model.features_and_rpn(image)
            mark()
            rois, _, _ = generate_proposals(
                torch.softmax(rpn_cls, -1)[..., 1], rpn_bbox, anchors, im_info,
                stride, int(test.RPN_PRE_NMS_TOP_N),
                int(test.RPN_POST_NMS_TOP_N), float(test.RPN_NMS_THRESH),
                float(test.RPN_MIN_SIZE))
            mark()
            cls_score, bbox_pred, fc2 = model.head(
                feat, rois, int(test.RPN_POST_NMS_TOP_N))
            mark()
            ln = model.learn_nms(cls_score, bbox_pred, rois, fc2, im_info,
                                 float(test.LEARN_NMS_CLASS_SCORE_TH))
            mark()
            final = merge_multi_score(ln["nms_multi_score"], int(test.MERGE_METHOD))
            F_, C = final.shape
            ids = torch.arange(1, C + 1, device=dev)[None].expand(F_, C)
            _topk_detections(ids.reshape(-1), final.reshape(-1),
                             (ln["sorted_bbox"] / im_info[2]).reshape(-1, 4),
                             (final > float(test.SCORE_THRESH)).reshape(-1),
                             int(test.max_per_image))
            mark()
            for k, (a, b) in zip(stages, zip(t[:-1], t[1:])):
                stages[k].append((b - a) * 1e3)
            stages["total"].append((t[-1] - t[0]) * 1e3)
    print("stage split, host clock ms (median of %d): %s" % (args.requests, "; ".join(
        f"{k} {statistics.median(v):.3f}" for k, v in stages.items())))

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.requests):
            predict(image, im_info)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if args.trace:
        prof.export_chrome_trace(args.trace)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    n_kernels = len(spans)
    print(f"profiled {args.requests} requests: wall {wall_us / 1e3:.3f} ms, device "
          f"busy {busy / 1e3:.3f} ms, idle share {1 - busy / wall_us:.3f}, "
          f"{n_kernels / args.requests:.0f} device ops per request")
    rows = sorted(prof.key_averages(), key=lambda r: -r.self_device_time_total)
    print("top device time per request (us): " + "; ".join(
        f"{r.key[:60]} {r.self_device_time_total / args.requests:.1f} "
        f"(x{r.count // args.requests})"
        for r in rows[:15] if r.self_device_time_total > 0))


if __name__ == "__main__":
    main()
