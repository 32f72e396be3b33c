"""The control of an END2END training cell (mix kind ``train_e2e``) read by
the cell's own four numbers: the plain reference in TF32 put in the
program's place, as the driver's ``judge`` reads the program.

    python benchmark/tools/control_e2e.py --workload <cell> --seeds 1 2 3

On the cell's own weights and batches (``drivers/train_e2e.py::build``):
the TF32 reference's first-step proposals against the float32 reference's
own (``prop_unmatched_share``); then the TF32 and the float32 reference
both following the TF32 one's proposals of each check step from the
first weights, by the worst step's loss gap, the median leaf's
first-gradient gap and the median leaf's change gap (the worst leaf's
gaps beside them). benchmark/tools/control.py reads the generic numbers
(each side on its own proposals). Prints one JSON line a seed. Runs on a
card (TF32 exists only there); the benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def readings(config, mix, ref, seed, device):
    from benchmark.harness import cells, compare
    from benchmark.tools.control import _with_tf32
    driver = cells.driver(mix["kind"])
    ctx = {"config": config, "reference": ref, "mix": mix, "seed": seed,
           "device": device, "rehearse": device.type == "cpu", "fault": ""}
    model, _, _, W, batches = driver.build(ctx)
    del model
    steps = batches[:int(mix["check_steps"])]
    low = [_with_tf32(True, ref.first_proposals, W, config, b) for b in steps]
    own = _with_tf32(False, ref.first_proposals, W, config, steps[0])
    missing = sum(driver._unmatched(p, o) for p, o in zip(low[0], own))
    follow = [dict(b, proposals=p) for b, p in zip(steps, low)]
    got = _with_tf32(True, ref.train_steps, W, config, follow, len(follow))
    want = _with_tf32(False, ref.train_steps, W, config, follow, len(follow))
    skip, r_grad, _ = compare.nongrad_floor(want[1])
    g_grad = {k: float(v.norm()) for k, v in got[1].items()}
    r_change = {k: float((v - W[k]).norm()) for k, v in want[2].items()}
    g_change = {k: float((v - W[k]).norm()) for k, v in got[2].items()}
    return {"prop_unmatched_share": missing / (own.shape[0] * own.shape[1]),
            "loss_gap": max(compare.math_rel(a, b) for a, b in zip(got[0], want[0])),
            "grad_gap_med": compare.median_leaf_gap(g_grad, r_grad, skip),
            "change_gap_med": compare.median_leaf_gap(g_change, r_change, skip),
            "grad_gap_worst": compare.worst_leaf_gap(g_grad, r_grad, skip),
            "change_gap_worst": compare.worst_leaf_gap(g_change, r_change, skip)}


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
    for seed in args.seeds:
        got = readings(config, mix, spec["reference"], seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "readings": got}), flush=True)


if __name__ == "__main__":
    main()
