"""Spreads of two sets of runs of one cell (repeat.py's output files), and
the bound they suggest.

    python benchmark/tools/bounds.py set_a.jsonl set_b.jsonl

For each end-to-end metric: each set's median and spread (the distance
between the first and third quartile of ``statistics.quantiles(n=4)``, as a
share of the median), the wider of the two times five (the suggested bound,
at least 1%), the mean of the two spreads with each set's run farthest from
its median left out (what a check holds against half the bound), and the
spread of all runs together (what a check holds against an eighth of it).
"""

from __future__ import annotations

import json
import statistics
import sys


def spread(values):
    if len(values) < 3:
        return float("nan")
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def trimmed(values):
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return [v for i, v in enumerate(values) if i != far]


def load(path):
    return [json.loads(line)["result"] for line in open(path) if line.strip()]


def main(a_path, b_path):
    a, b = load(a_path), load(b_path)
    for name in a[0]["metrics"]:
        va = [r["metrics"][name]["value"] for r in a if r]
        vb = [r["metrics"][name]["value"] for r in b if r]
        sa, sb = spread(va), spread(vb)
        tight = 0.5 * (spread(trimmed(va)) + spread(trimmed(vb)))
        print(f"{name}: medians {statistics.median(va):.6g} / "
              f"{statistics.median(vb):.6g}, spreads {sa:.4%} / {sb:.4%}, "
              f"suggested bound {max(0.01, 5 * max(sa, sb)):.4f}, trimmed mean "
              f"spread {tight:.4%}, all runs {spread(va + vb):.4%}")


if __name__ == "__main__":
    main(*sys.argv[1:3])
