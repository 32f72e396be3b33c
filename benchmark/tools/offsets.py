"""Measure the offset layers' scale factors of a deformable configuration.

    python benchmark/tools/offsets.py --config dcn_learn_nms [--seeds 3]
        [--size 256 384] [--device cpu]

An offset layer at zero, as the published models start, puts every sample
on the integer grid and leaves the deformable mechanism idle; the seeded
weights of benchmark/harness/weights.py, unscaled, move it by an arbitrary
amount. This runs the configuration's plain reference (its
``offset_outputs``: each res5 unit's offset conv, then the head's
``offset`` FC over the request's proposals) on seeded images and, layer
after layer in the order a request runs them, takes the factor that gives
the layer's output (bias removed) standard deviation 1: about a
feature-map pixel of offset in res5, and a bin shift of a tenth of the
ROI's size (trans_std 0.1) in the head. Each later layer sees the earlier
ones scaled; the four prediction layers keep the configuration file's
factors. Prints the median factor of each layer over the seeds, for the
configuration file's ``init.head_scale``; run benchmark/tools/calibrate.py
on top of them.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

SPREAD = 1.0


def factors(config, seed, size, device):
    from benchmark.harness import cells, traffic
    from benchmark.harness.weights import make_weights
    ref = cells.reference(config)
    c = json.loads(json.dumps(config))
    c["images"] = {"bucket": list(size), "sizes": [[size[0], size[1], 1.0]]}
    for k in ref.OFFSET_LAYERS:
        c["init"]["head_scale"][k] = 1.0
    P = make_weights(ref, c, seed, device)
    img, info = traffic.images(c, 1, seed, device)
    got = {}
    for layer, y in ref.offset_outputs(P, c, img[0], info[0]):
        got[layer] = SPREAD / float(y.std())
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
    print(json.dumps({k: statistics.median(p[k] for p in per) for k in per[0]}))


if __name__ == "__main__":
    with __import__("torch").no_grad():
        main()
