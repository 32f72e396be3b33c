"""Measure the four prediction layers' scale factors of a configuration.

    python benchmark/tools/calibrate.py --config flagship [--seeds 3]
        [--size 256 384] [--device cpu]

The weights of benchmark/harness/weights.py with every factor 1 give RPN
logits and box deltas far beyond a trained detector's (every proposal is
clipped to the whole image). This runs the configuration's plain
reference (its ``calibration_outputs``) on seeded images and, layer after
layer in the order a request runs them, takes the factor that gives the
layer's output (bias removed, over every level and image) the spread of a
trained detector: RPN and class logits std 2, box deltas std 0.2; each
later layer sees the earlier ones scaled. Prints the
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
    from benchmark.harness import cells, traffic
    from benchmark.harness.weights import make_weights
    ref = cells.reference(config)
    c = json.loads(json.dumps(config))
    c["images"] = {"bucket": list(size),
                   "sizes": [[size[0], size[1], 1.0]]}
    for k in SPREAD:
        c["init"]["head_scale"][k] = 1.0
    P = make_weights(ref, c, seed, device)
    img, info = traffic.images(c, 1, seed, device)
    got = {}
    for layer, y in ref.calibration_outputs(P, c, img[0], info[0]):
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
