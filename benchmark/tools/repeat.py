"""Run one cell several times, one process a run, and summarise.

    python benchmark/tools/repeat.py --workload <cell> --seeds 1 2 3 \
        --seconds 20 [--trace 0|1] [--out runs.jsonl] [-- <run.py options>]

Each run is ``python benchmark/run.py`` with one seed; its last standard
output line (the result) is kept with the seed, the exit code, its wall
time and its last standard error lines, one JSON line a run in ``--out``.
The summary gives each metric's values, median and spread (the distance
between the first and third quartile of ``statistics.quantiles(n=4)``, as
a share of the median) and each check's readings.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values):
    if len(values) < 2:
        return float("nan")
    q = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q[2] - q[0]) / med if med else float("nan")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--timeout", type=float, default=1200)
    ap.add_argument("rest", nargs="*")
    args = ap.parse_args()
    rows = []
    for seed in args.seeds:
        cmd = [sys.executable, "benchmark/run.py", "--workload", args.workload,
               "--seed", str(seed), "--seconds", str(args.seconds),
               "--trace", str(args.trace)] + args.rest
        t = time.perf_counter()
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=args.timeout)
        wall = time.perf_counter() - t
        lines = p.stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            res = None
        row = {"seed": seed, "rc": p.returncode, "wall_s": wall, "result": res,
               "stderr_tail": p.stderr[-3000:]}
        rows.append(row)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        brief = ({k: round(v["value"], 4) for k, v in res["metrics"].items()}
                 if res else p.stderr[-1500:])
        checks = ({k: v["value"] for k, v in res["checks"].items()} if res else {})
        print(f"seed {seed} rc {p.returncode} wall {wall:.1f}s correct "
              f"{res and res['correct']} {brief} {checks}", flush=True)
    ok = [r["result"] for r in rows if r["result"]]
    if not ok:
        return
    print("summary", args.workload, f"runs {len(ok)}")
    for name in ok[0]["metrics"]:
        vals = [r["metrics"][name]["value"] for r in ok if name in r["metrics"]]
        print(f"  {name}: median {statistics.median(vals):.6g} spread "
              f"{spread(vals):.4%} values {[round(v, 5) for v in vals]}")
    for name in ok[0]["checks"]:
        vals = [r["checks"][name]["value"] for r in ok]
        print(f"  check {name}: max {max(vals):.4g} values {vals}")


if __name__ == "__main__":
    main()
