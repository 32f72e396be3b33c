"""A traced window's profiler trace reduced to the program's own stages.

A traced run enables the program's registry for its set-up and for a
window of its own, traced after the first (``window``, below), so that the
program's spans (relation_tpu_torch/utils/trace.py) sit in that trace as
``rn:<stage>`` records on the host threads that opened them: ``predict``
and ``predict.{input,trunk_rpn,proposals,head,tail}`` of a request,
``step`` and ``step.{input,trunk_rpn,rois,backward,allreduce,update}`` of
a train step. The first traced window, which the benchmark's own spans and
``idle_share`` read, runs with the registry off, as an untraced run does.
At each moment the stage of a thread is its innermost open span, and the
stage of the process the innermost span open on any thread (the one opened
last); ``outside`` where none is open (the caller's code, such as a
client's ``.cpu()`` of the detections). For each stage:

- host_ms: the time it was a thread's stage, summed over threads
  (``outside``: the time no stage was open on any thread);
- dev_ms: the device's busy time with the operations launched under it
  (their intervals merged, as the busy time merges all), each put down to
  the stage of the thread of its launch (the runtime call linked by the
  correlation id) at the launch, else to the process's stage then: a
  train step's backward runs on autograd's own thread, which opens no
  span, while the step's thread waits in ``step.backward``;
- idle_ms: the device's idle time, the window less the merged busy
  intervals, each idle interval split over the process's stages that it
  spans;
- syncs: the host's waits on the device (trace.SYNC_CALLS), each put down
  like a launch, and counted by its site: the innermost ``aten::`` op
  around it on its thread (``aten::copy_`` for a blocking copy, ``aten::
  item`` for a read), "-" where none is.

With K > 1 clients the process's stage is the stage of the client whose
span opened last, so idle time is not split between concurrent requests.
"""

from __future__ import annotations

import bisect
import gc

import torch

from benchmark.harness.trace import ANNOTATIONS, SYNC_CALLS, merged, profile

STAGE_PREFIX = "rn:"
OUTSIDE = "outside"


def is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def _is_runtime(name: str) -> bool:
    """A CUDA runtime or driver call (cudaLaunchKernel, cuLaunchKernel,
    cudaMemcpyAsync, ...), which carries the correlation id of what it
    launched."""
    return name.startswith("cu") and not name.startswith("cudnn")


class Timeline:
    """The innermost open span over time: sorted segments (start, end,
    name) with no span open between them."""

    def __init__(self, spans):
        edges = sorted({t for s, e, _ in spans for t in (s, e)})
        by_start = sorted(spans)
        self.segs = []
        open_, i = [], 0
        for a, b in zip(edges, edges[1:]):
            while i < len(by_start) and by_start[i][0] <= a:
                open_.append(by_start[i])
                i += 1
            open_ = [sp for sp in open_ if sp[1] > a]
            if open_:
                # innermost: opened last, and the shorter of two opened at once
                s, e, name = max(open_, key=lambda sp: (sp[0], -sp[1]))
                last = self.segs[-1] if self.segs else None
                if last and last[2] == name and last[1] == a:
                    last[1] = b
                else:
                    self.segs.append([a, b, name])
        self.starts = [s for s, _, _ in self.segs]

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.segs[i][1]:
            return self.segs[i][2]
        return None

    def split(self, a, b):
        """{name: overlap} of [a, b) with the segments; the rest under
        OUTSIDE."""
        out, covered = {}, 0.0
        i = max(bisect.bisect_right(self.starts, a) - 1, 0)
        while i < len(self.segs) and self.segs[i][0] < b:
            s, e, name = self.segs[i]
            ov = min(e, b) - max(s, a)
            if ov > 0:
                out[name] = out.get(name, 0.0) + ov
                covered += ov
            i += 1
        if b - a - covered > 0:
            out[OUTSIDE] = out.get(OUTSIDE, 0.0) + (b - a - covered)
        return out


def reduce(events, window=None) -> dict:
    """{"window_ms", "busy_ms", "linked", "stages": {stage: {"host_ms",
    "dev_ms", "idle_ms", "syncs", "sync_sites"}}} over the whole window
    (the extent of the events, or ``window`` = (start, end) in the trace's
    microseconds); "linked" is the share of the device operations whose
    launch the trace links; a sync's site is the innermost ``aten::`` op
    around it on its thread. No stages where the trace has no ``rn:``
    records."""
    events = list(events)
    dev, spans, syncs, runtime, ops = [], [], [], {}, {}
    for e in events:
        name = e.name
        if is_device(e):
            if not name.startswith(ANNOTATIONS):
                dev.append(e)
            continue
        if name.startswith(STAGE_PREFIX):
            spans.append((e.time_range.start, e.time_range.end,
                          name[len(STAGE_PREFIX):], e.thread))
        elif name.startswith("aten::"):
            ops.setdefault(e.thread, []).append(
                (e.time_range.start, e.time_range.end, name))
        elif name in SYNC_CALLS:
            syncs.append(e)
        if _is_runtime(name) and e.id:
            runtime[e.id] = e
    if window is None:
        ranges = [(e.time_range.start, e.time_range.end) for e in events]
        window = (min((r[0] for r in ranges), default=0.0),
                  max((r[1] for r in ranges), default=0.0))
    w0, w1 = window
    every = Timeline([(s, e, n) for s, e, n, _ in spans])
    threads = {}
    for s, e, n, tid in spans:
        threads.setdefault(tid, []).append((s, e, n))
    per_thread = {tid: Timeline(sp) for tid, sp in threads.items()}
    stages: dict[str, dict] = {}

    def row(name):
        return stages.setdefault(name or OUTSIDE, {
            "host_ms": 0.0, "dev_ms": 0.0, "idle_ms": 0.0, "syncs": 0,
            "sync_sites": {}})

    def stage_of(tid, t):
        own = per_thread.get(tid)
        return (own.at(t) if own else None) or every.at(t)

    for tl in per_thread.values():
        for s, e, name in tl.segs:
            row(name)["host_ms"] += (e - s) / 1e3
    if spans:
        row(OUTSIDE)["host_ms"] = every.split(w0, w1).get(OUTSIDE, 0.0) / 1e3
    by_stage, linked = {}, 0
    for e in dev:
        launch = runtime.get(e.id)
        linked += launch is not None
        name = (stage_of(launch.thread, launch.time_range.start) if launch
                else every.at(e.time_range.start))
        by_stage.setdefault(name, []).append((e.time_range.start,
                                              e.time_range.end))
    for name, iv in by_stage.items():
        row(name)["dev_ms"] = sum(e - s for s, e in merged(iv)) / 1e3
    op_lines = {}
    for e in syncs:
        r = row(stage_of(e.thread, e.time_range.start))
        r["syncs"] += 1
        if e.thread not in op_lines:
            op_lines[e.thread] = Timeline(ops.get(e.thread, []))
        site = op_lines[e.thread].at(e.time_range.start) or "-"
        r["sync_sites"][site] = r["sync_sites"].get(site, 0) + 1
    busy = merged((e.time_range.start, e.time_range.end) for e in dev)
    busy_us = sum(e - s for s, e in busy)
    cursor = w0
    for s, e in busy + [[w1, w1]]:
        if s > cursor:
            for name, us in every.split(cursor, min(s, w1)).items():
                row(name)["idle_ms"] += us / 1e3
        cursor = max(cursor, e)
    if not spans:
        stages = {}
    return {"window_ms": (w1 - w0) / 1e3, "busy_ms": busy_us / 1e3,
            "linked": linked / max(len(dev), 1), "stages": stages}


def window(registry, run_window, seconds: float, cuda: bool, images):
    """The stage window: ``run_window`` traced for ``seconds`` with the
    registry on, then off again. Returns (its stage reduction with
    ``images``, the images the window served, ``images(what run_window
    returned)``, and ``window_s``, its length on the host's clock; the
    registry's snapshot of the window). What the first traced window left
    to the garbage collector is collected first, not inside this one."""
    gc.collect()
    registry.reset()
    registry.enable()
    try:
        prof, wall, got = profile(run_window, seconds, cuda)
    finally:
        registry.disable()
    snap = registry.snapshot()
    registry.reset()
    st = dict(reduce(prof.events()), images=images(got), window_s=wall)
    return st, snap


def _window(out):
    """The stage window's reduction, where its trace has device events and
    images; else None."""
    st = (out.get("trace") or {}).get("stages")
    if not st or st["busy_ms"] <= 0 or not st.get("images"):
        return None
    return st


def per_image(out, stage: str, key: str):
    """``key`` of ``stage`` a traced image, read from the run's summary;
    None where the trace has no device events or no stages. ``stage`` is a
    step's or a request's stage without its prefix ("input", "trunk_rpn",
    ...), or "outside"."""
    st = _window(out)
    if st is None or not st["stages"]:
        return None
    if stage != OUTSIDE:
        stage = ("step." if out["kind"] == "train" else "predict.") + stage
    return st["stages"].get(stage, {}).get(key, 0.0) / st["images"]


def program(out, which: str = "program"):
    """The registry's snapshot of the stage window ("program") or of the
    set-up ("program_setup"), where the stage window's trace has device
    events."""
    return None if _window(out) is None else out.get(which)


def images(out) -> int:
    """The images of the stage window, over which the registry's window
    counts are taken."""
    return out["trace"]["stages"]["images"]


def table(st: dict, images: int) -> str:
    """The stage table as one line, per image."""
    rows = sorted(st["stages"].items(), key=lambda kv: -kv[1]["idle_ms"])
    return ("stages per image (host ms / device ms / idle ms / syncs [by "
            f"site]) over {images} images: " + "; ".join(
                f"{k} {v['host_ms'] / images:.3f} / {v['dev_ms'] / images:.3f}"
                f" / {v['idle_ms'] / images:.3f} / {v['syncs'] / images:.2f} "
                + str({op: round(n / images, 2)
                       for op, n in v["sync_sites"].items()})
                for k, v in rows))
