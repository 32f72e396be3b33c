"""Measure the four prediction layers' scale factors of a configuration.

    python benchmark/tools/calibrate.py --config flagship [--seeds 3]
        [--size 256 384] [--device cpu]

The weights of benchmark/harness/weights.py with every factor 1 give RPN
logits and box deltas far beyond a trained detector's (every proposal is
clipped to the whole image). This runs the plain reference on seeded
images and, layer after layer in the order a request runs them, takes the
factor that gives the layer's output (bias removed, over every level and
image) the spread of a trained detector: RPN and class logits std 2, box
deltas std 0.2; each later layer sees the earlier ones scaled. Prints the
median factor of each layer over the seeds, for the configuration file's
``init.head_scale``. The statistics are per pixel and per ROI, so a small
image serves.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

SPREAD = {"rpn.rpn_cls_score": 2.0, "rpn.rpn_bbox_pred": 0.2,
          "cls_score": 2.0, "bbox_pred": 0.2}


def factors(config, seed, size, device):
    import torch
    from benchmark.harness import traffic
    from benchmark.harness.weights import make_weights
    from benchmark.reference import detector as ref
    c = json.loads(json.dumps(config))
    c["images"] = {"bucket": list(size),
                   "sizes": [[size[0], size[1], 1.0]]}
    for k in SPREAD:
        c["init"]["head_scale"][k] = 1.0
    P = make_weights(c, seed, device)
    img, info = traffic.images(c, 1, seed, device)
    a = c["arch"]
    x = ref.image_from_u8(img[0], info[0], a["pixel_means"])
    outs = ref.trunk(P, x, a["trunk"] == "fpn")
    feats = (list(ref.fpn_neck(P, outs).values()) if a["trunk"] == "fpn"
             else [outs[4]])
    got = {}
    for layer in ("rpn.rpn_cls_score", "rpn.rpn_bbox_pred"):
        hid = [torch.relu(ref._conv(P, "rpn.rpn_conv_3x3", f, 1, 1)) for f in feats]
        y = torch.cat([ref._conv(P, layer, h).flatten(1) - P[f"{layer}.bias"][:, None]
                       for h in hid], 1)
        got[layer] = SPREAD[layer] / float(y.std())
        P[f"{layer}.weight"] *= got[layer]
    # the head's input: the ROIs the calibrated RPN proposes
    raw = []
    A = int(a["num_anchors"])
    t = c["test"]
    top = (int(t["rpn_pre_nms_top_n"]), int(t["rpn_post_nms_top_n"]),
           float(t["rpn_nms_thresh"]))
    if a["trunk"] == "fpn":
        levels = dict(zip(ref.FPN_STRIDES, feats))
        for s in ref.FPN_STRIDES:
            cls, bb = ref.rpn_head(P, levels[s])
            cc = cls[0].permute(2, 0, 1)
            raw.append((torch.sigmoid(cc[1::2] - cc[0::2]),
                        bb[0].permute(2, 0, 1).reshape(A, 4, *cc.shape[1:]), s))
        rois = ref.proposals(raw, info[0], top, (a["anchor_ratios"], a["anchor_scales"]))
        pooled = ref.pool_levels({s: levels[s][0].permute(1, 2, 0)
                                  for s in ref.DISPATCH_STRIDES}, rois)
        fc = ("roi_pool_fc1", "roi_pool_fc2")
    else:
        cls, bb = ref.rpn_head(P, feats[0])
        h, w = cls.shape[1:3]
        fg = torch.softmax(cls[0].reshape(h, w, A, 2), -1)[..., 1].permute(2, 0, 1)
        d = bb[0].reshape(h, w, A, 4).permute(2, 3, 0, 1)
        rois = ref.proposals([(fg, d, 16)], info[0], top,
                             (a["anchor_ratios"], a["anchor_scales"]))
        feat = torch.relu(ref._conv(P, "conv_new_1", outs[5]))[0].permute(1, 2, 0)
        pooled = ref.roi_align(feat, rois, 1.0 / 16)
        fc = ("fc_new_1", "fc_new_2")
    _, _, fc2 = ref.head(P, fc, pooled, rois, rois.shape[0])
    for layer in ("cls_score", "bbox_pred"):
        y = torch.nn.functional.linear(fc2, P[f"{layer}.weight"])
        got[layer] = SPREAD[layer] / float(y.std())
        P[f"{layer}.weight"] *= got[layer]
    return got


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--size", type=int, nargs=2, default=(256, 384))
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = json.loads((ROOT / "benchmark" / "configs"
                         / f"{args.config}.json").read_text())
    per = [factors(config, s, args.size, torch.device(args.device))
           for s in range(args.seeds)]
    for p in per:
        print(json.dumps(p))
    print(json.dumps({k: statistics.median(p[k] for p in per) for k in SPREAD}))


if __name__ == "__main__":
    with __import__("torch").no_grad():
        main()
