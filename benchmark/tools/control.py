"""The control of a cell's correctness check: the plain reference put in
the program's place, computed one precision below the configuration's
(float32 with TF32 on, for float32 with TF32 off), read against the
reference in the stated precision by the numbers the cell's check
compares, on the cell's own inputs at its own size.

    python benchmark/tools/control.py --workload <cell> --seeds 1 2 3

Prints one JSON line a seed: {"seed", "readings": {check: value}}. The
check has to fail on the control: each reading against the limits in the
configuration file. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def _with_tf32(on: bool, fn, *a):
    import torch
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        return fn(*a)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def train_readings(config, mix, seed, device):
    """The control's readings of a training cell: the weights and the
    batches as its driver's ``build`` makes them."""
    from benchmark.harness import cells, compare
    ref = cells.reference(config)
    ctx = {"config": config, "reference": ref, "mix": mix, "seed": seed,
           "device": device, "rehearse": device.type == "cpu", "fault": ""}
    model, _, _, W, batches = cells.driver(mix["kind"]).build(ctx)
    del model
    n = int(mix["check_steps"])
    want = _with_tf32(False, ref.train_steps, W, config, batches, n)
    got = _with_tf32(True, ref.train_steps, W, config, batches, n)
    skip, r_grad, _ = compare.nongrad_floor(want[1])
    g_grad = {k: float(v.norm()) for k, v in got[1].items()}
    r_change = {k: float((v - W[k]).norm()) for k, v in want[2].items()}
    g_change = {k: float((v - W[k]).norm()) for k, v in got[2].items()}
    return {"loss_gap": max(compare.math_rel(a, b)
                            for a, b in zip(got[0], want[0])),
            "grad_gap": compare.worst_leaf_gap(g_grad, r_grad, skip)[0],
            "change_gap_med": compare.median_leaf_gap(g_change, r_change, skip),
            "change_gap_worst": compare.worst_leaf_gap(g_change, r_change, skip)[0]}


def serve_readings(config, mix, seed, device):
    import torch
    from benchmark.harness import cells, compare, traffic
    from benchmark.harness.weights import make_weights
    ref = cells.reference(config)
    W = make_weights(ref, config, seed, device)
    imgs, infos = traffic.images(config, int(mix["pool_images"]), seed, device)
    pick = random.Random(seed + 1).sample(range(len(imgs)),
                                          min(int(mix["check_requests"]), len(imgs)))
    top = int(config["limits"]["serve"]["top"])
    summarise = cells.driver(mix["kind"]).summarise
    got = []
    with torch.no_grad():
        for j in pick:
            want = _with_tf32(False, ref.predict, W, config, imgs[j], infos[j]).cpu()
            low = _with_tf32(True, ref.predict, W, config, imgs[j], infos[j]).cpu()
            got.append(compare.dets_gap(low, want, top))
    return {k: v for k, (v, _) in summarise(got, config["limits"]["serve"]).items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args()
    import torch
    from benchmark.harness import cells
    from benchmark.harness.common import rehearsal
    spec = cells.resolve(args.workload, ROOT)
    config, mix = spec["config"], spec["mix"]
    if args.rehearse:
        config, mix = rehearsal(config, mix)
    device = torch.device("cpu" if args.rehearse else "cuda")
    kind = cells.driver(mix["kind"], ROOT).KIND
    for seed in args.seeds:
        if kind == "train":
            got = train_readings(config, mix, seed, device)
        else:
            got = serve_readings(config, mix, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "readings": got}), flush=True)


if __name__ == "__main__":
    main()
