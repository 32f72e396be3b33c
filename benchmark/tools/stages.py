"""One run of a cell, as benchmark/run.py makes it, and what the program's
span-and-counter registry (relation_tpu_torch/utils/trace.py) read.

    python benchmark/tools/stages.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1> [--registry 0|1] [--rehearse]

run.py turns the registry on in every traced run, for the set-up and for
a stage window of its own (benchmark/harness/stages.py::window), and
leaves it off in every untraced one. In an untraced run this tool's
``--registry 1`` (the default) enables the registry itself before run.py
builds anything, so that the set-up and the timed window pay its cost:
the same untraced run with ``--registry 1`` and ``--registry 0`` compares
the registry's on-cost on one seed, each run's result line giving the
end-to-end metrics. With the registry on, one JSON line after run.py's
result line gives the registry's readings of the whole untraced run (each
span's calls and host ms a call, the counters), or, in a traced run, the
stage table (per image; its one line also goes to standard error), the
consistency of the stages with the stage window's own length and busy
time, and the registry's snapshots.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def consistency(out) -> dict:
    """The stages against the stage window: idle time summed over the
    stages against the window less the busy time, device time and syncs
    summed over the stages, and the host reads a stage image."""
    st = out["trace"]["stages"]
    rows = st["stages"].values()
    n = st["images"]
    res = {"images": n,
           "stage_idle_ms": sum(r["idle_ms"] for r in rows),
           "window_less_busy_ms": 1e3 * st["window_s"] - st["busy_ms"],
           "trace_window_less_busy_ms": st["window_ms"] - st["busy_ms"],
           "stage_dev_ms_per_img": sum(r["dev_ms"] for r in rows) / n,
           "busy_ms_per_img": st["busy_ms"] / n,
           "stage_syncs_per_img": sum(r["syncs"] for r in rows) / n}
    reads = sum(v for k, v in out["program"]["counters"].items()
                if k.startswith("host_read."))
    res["host_reads_per_img"] = reads / n
    return res


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    registry_on = True
    if "--registry" in args:
        i = args.index("--registry")
        registry_on = args[i + 1] == "1"
        del args[i:i + 2]
    traced = "--trace" in args and args[args.index("--trace") + 1] == "1"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark import run
    from benchmark.harness import stages
    from relation_tpu_torch.utils import trace as registry
    if registry_on and not traced:
        registry.reset()
        registry.enable()
    summaries = []
    rc = run.main(args, keep=summaries)
    if rc or not summaries or not registry_on:
        print(json.dumps({"registry": registry_on}), flush=True)
        return rc
    out = summaries[0]
    if not traced:
        snap = registry.snapshot()
        line = {"registry": True, "run": {
            k: {"calls": v["count"], "host_ms_a_call": 1e3 * v["total_s"] / v["count"]}
            for k, v in snap["spans"].items()}, "counters": snap["counters"]}
        print(json.dumps(line), flush=True)
        return rc
    st = out["trace"]["stages"]
    n = st["images"]
    print(stages.table(st, n), file=sys.stderr, flush=True)
    line = {"registry": True,
            "stages": {k: {q: (v / n if q != "sync_sites" else
                               {op: c / n for op, c in v.items()})
                           for q, v in row.items()}
                       for k, row in st["stages"].items()},
            "consistency": consistency(out), "program": out["program"],
            "program_setup": out["program_setup"]}
    print(json.dumps(line), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
