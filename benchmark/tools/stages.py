"""One run of a cell, as benchmark/run.py makes it, with the program's
span-and-counter registry (relation_tpu_torch/utils/trace.py) enabled.

    python benchmark/tools/stages.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1> [--registry 0|1] [--rehearse]

``--registry 1`` enables the registry before anything is built, so that
the untimed set-up and the timed window pay its cost: the same run with
``--registry 0`` is run.py's own, and the two compare the registry's
on-cost on one seed. With ``--trace 1`` as well, the registry's set-up
snapshot is taken before the traced window, the registry is reset, and
after the window its snapshot and the stage reduction of the window's
profiler trace (benchmark/harness/stages.py) join the run's summary as
``program_setup``, ``program`` and ``trace.stages``. The stage table
then goes to standard error before the check lines, and after run.py's
result line one JSON
line gives the readings of the per-layer readers that read the stages
(STAGE_METRICS, those of the cell's kind) and the consistency of the
stages with the trace's own reduction (benchmark/harness/trace.py).

The profiler's copies of the ``rn:`` records on the device's timeline
are taken out of the trace that reduction reads, as it takes out its
own ``pb:`` records, so that its busy time counts device work only.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

STAGE_METRICS = (
    "proposals_dev_ms.serve", "idle_input_ms.serve", "idle_trunk_ms.serve",
    "idle_proposals_ms.serve", "idle_head_ms.serve", "idle_tail_ms.serve",
    "idle_outside_ms.serve", "bwd_dev_ms.train", "idle_input_ms.train",
    "idle_trunk_ms.train", "idle_rois_ms.train", "idle_bwd_ms.train",
    "idle_update_ms.train", "idle_outside_ms.train",
    "host_reads_per_img.serve", "host_reads_per_img.train",
    "dev_allocs_per_img.serve", "dev_allocs_per_img.train",
    "setup_kernels_s.serve", "setup_kernels_s.train", "setup_model_s.serve",
    "setup_model_s.train", "first_call_s.serve", "first_call_s.train")


class _Events:
    """A profiler's events without the device copies of the ``rn:``
    records."""

    def __init__(self, prof):
        self.prof = prof

    def events(self):
        from benchmark.harness import stages
        return [e for e in self.prof.events()
                if not (stages.is_device(e)
                        and e.name.startswith(stages.STAGE_PREFIX))]


def _instrument(registry, summaries):
    """Wrap the harness's reset_mem (the end of set-up), trace.profile and
    trace.reduce, and each driver's run, to take the registry's snapshots:
    of the set-up, of the untimed window and of the traced one."""
    from benchmark.harness import serve, stages, trace, train
    profile, reduce, reset_mem = trace.profile, trace.reduce, train.reset_mem
    taken = {}

    def end_of_setup(ctx):
        taken["program_setup"] = registry.snapshot()
        registry.reset()
        reset_mem(ctx)

    def traced_profile(run_window, seconds, cuda=True):
        taken["program_window"] = registry.snapshot()
        registry.reset()
        prof, window, out = profile(run_window, seconds, cuda)
        taken["program"] = registry.snapshot()
        taken["stages"] = stages.reduce(prof.events())
        return prof, window, out

    serve.reset_mem = train.reset_mem = end_of_setup
    trace.profile = traced_profile
    trace.reduce = lambda prof: reduce(_Events(prof))
    for mod in (serve, train):
        def run(ctx, t_start, _run=mod.run):
            out = _run(ctx, t_start)
            taken.setdefault("program_window", registry.snapshot())
            out.update(taken)
            if "stages" in taken:
                out["trace"]["stages"] = out.pop("stages")
                # before run.py's check lines, which end standard error
                print(stages.table(out["trace"]["stages"],
                                   out["trace"]["images"]),
                      file=sys.stderr, flush=True)
            summaries.append(out)
            return out
        mod.run = run


def consistency(out) -> dict:
    """The stages against the trace's own reduction: idle and device time
    and syncs summed over the stages, and the host reads against the
    syncs."""
    t, st = out["trace"], out["trace"]["stages"]
    rows = st["stages"].values()
    n = t["images"]
    idle = sum(r["idle_ms"] for r in rows)
    res = {"images": n,
           "stage_idle_ms": idle,
           "window_less_busy_ms": 1e3 * (t["window_s"] - t["busy_s"]),
           "trace_window_less_busy_ms": st["window_ms"] - st["busy_ms"],
           "stage_dev_ms_per_img": sum(r["dev_ms"] for r in rows) / n,
           "busy_ms_per_img": 1e3 * t["busy_s"] / n,
           "stage_syncs": sum(r["syncs"] for r in rows),
           "trace_syncs": t["syncs"],
           "pb_span_dev_ms_per_img": {k: 1e3 * v / n for k, v in
                                      t["span_device_s"].items()}}
    reads = sum(v for k, v in out["program"]["counters"].items()
                if k.startswith("host_read."))
    res["host_reads_per_img"] = reads / n
    res["host_syncs_per_img"] = t["syncs"] / n
    return res


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    registry_on = True
    if "--registry" in args:
        i = args.index("--registry")
        registry_on = args[i + 1] == "1"
        del args[i:i + 2]
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark import run
    from benchmark.harness import cells
    from relation_tpu_torch.utils import trace as registry
    summaries = []
    if registry_on:
        registry.enable()
        _instrument(registry, summaries)
    rc = run.main(args)
    if rc or not summaries:
        print(json.dumps({"registry": registry_on}), flush=True)
        return rc
    out = summaries[0]
    n = max(out["images"], 1)
    line = {"registry": True, "window": {
        k: {"calls_an_image": v["count"] / n,
            "host_ms_a_call": 1e3 * v["total_s"] / v["count"]}
        for k, v in out["program_window"]["spans"].items()},
        "window_counters": {k: v / n for k, v in
                            out["program_window"]["counters"].items()},
        "setup": out["program_setup"]["spans"],
        "setup_counters": out["program_setup"]["counters"]}
    if "stages" in out.get("trace", {}):
        t = out["trace"]
        line["metrics"] = {}
        for name in STAGE_METRICS:
            if name.endswith("." + out["kind"]):
                value = cells.metric_reader(name, ROOT)(out)
                if value is not None:
                    line["metrics"][name] = value
        line["stages"] = {k: {q: (v / t["images"] if q != "sync_sites" else
                                  {op: c / t["images"] for op, c in v.items()})
                              for q, v in row.items()}
                          for k, row in t["stages"]["stages"].items()}
        line["consistency"] = consistency(out)
        line["program"] = out["program"]
    print(json.dumps(line), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
