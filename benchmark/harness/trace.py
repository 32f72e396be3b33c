"""Spans around the calls into the program's modules, and the reduction of
a torch.profiler trace to what the per-layer readers read.

Spans are the benchmark's own: the bound methods and module forwards named
in SPANS are wrapped on the model instance in ``torch.profiler.
record_function`` for the traced window only. A span's device time is the
kernels launched under it (the forward; a train step's backward runs on
autograd's own thread, outside every span). The program's own spans
(``rn:``, relation_tpu_torch/utils/trace.py) are read by harness/stages.py.
"""

from __future__ import annotations

import bisect
import functools
import time

import torch

PREFIX = "pb:"
# the profiler's copies of the benchmark's and the program's records on the
# device's timeline: annotations, not device work
ANNOTATIONS = (PREFIX, "rn:")
# span name -> attribute paths on the model that open it
SPANS = {
    "pb:trunk_rpn": ("features_and_rpn",),
    "pb:head": ("head",),
    "pb:learn_nms": ("learn_nms",),
    "pb:attn": ("relation_1.forward", "relation_2.forward",
                "learn_nms_head.NMSRelationModule_0.forward"),
}
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def install_spans(model) -> list:
    """Wrap each SPANS attribute of ``model`` present on it; returns the
    (object, attribute) pairs to ``remove_spans`` afterwards."""
    done = []
    for span, paths in SPANS.items():
        for path in paths:
            *owner, attr = path.split(".")
            obj = model
            try:
                for part in owner:
                    obj = getattr(obj, part)
                fn = getattr(obj, attr)
            except AttributeError:
                continue

            def wrapped(*a, _fn=fn, _span=span, **k):
                with torch.profiler.record_function(_span):
                    return _fn(*a, **k)
            functools.update_wrapper(wrapped, fn)
            setattr(obj, attr, wrapped)
            done.append((obj, attr))
    return done


def remove_spans(done) -> None:
    for obj, attr in done:
        delattr(obj, attr)


def profile(run_window, seconds: float, cuda: bool = True):
    """Run ``run_window(deadline)`` under the profiler; returns (profiler,
    window seconds, what run_window returned)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    try:
        # record the host ops of every thread (the serving clients), where
        # this PyTorch has the option
        extra = {"experimental_config": torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)}
    except (AttributeError, TypeError):
        extra = {}
    with torch.profiler.profile(activities=acts, **extra) as prof:
        sync()
        t0 = time.perf_counter()
        out = run_window(t0 + seconds)
        sync()
        window = time.perf_counter() - t0
    return prof, window, out


def merged(spans):
    """Sorted (start, end) intervals merged where they overlap."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(prof) -> dict:
    """{busy_s, device_ops_n, span_device_s {span: s}, syncs, breakdown}:
    the breakdown's device_ops are the kernels, copies and sets on the
    device summed by name, its idle_gaps ``idle_gaps``."""
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    dev = [e for e in events if e.device_type == cuda
           and not e.name.startswith(ANNOTATIONS)]
    busy = merged((e.time_range.start, e.time_range.end) for e in dev)
    busy_us = sum(e - s for s, e in busy)
    spans = {}
    host = []
    syncs = 0
    for e in events:
        if e.device_type == cuda:
            continue
        if e.name.startswith(PREFIX):
            spans[e.name] = spans.get(e.name, 0.0) + e.device_time_total
            host.append((e.time_range.start, e.time_range.end, e.name, 1))
        elif e.name in SYNC_CALLS:
            syncs += 1
        elif e.name.startswith("aten::"):
            host.append((e.time_range.start, e.time_range.end, e.name, 0))
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end
                                                      - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    device_ops = [[name[:64], us / 1e6] for name, us in top]
    return {"busy_s": busy_us / 1e6, "device_ops_n": len(dev),
            "span_device_s": {k: v / 1e6 for k, v in spans.items()},
            "syncs": syncs,
            "breakdown": {"device_ops": device_ops,
                          "idle_gaps": idle_gaps(busy, host)}}


def idle_gaps(busy, host, top: int = 10):
    """The idle time between device intervals, summed by what the host was
    doing at each gap's middle: the innermost aten op there, else the
    innermost span, else '_host_between_ops_'."""
    host.sort()
    starts = [h[0] for h in host]
    by = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        gap = s1 - e0
        if gap <= 0:
            continue
        mid = 0.5 * (e0 + s1)
        i = bisect.bisect_right(starts, mid)
        op = span = None
        for j in range(i - 1, max(i - 400, -1), -1):
            s, e, name, is_span = host[j]
            if e >= mid:
                if is_span and span is None:
                    span = name
                elif not is_span and op is None:
                    op = name
            if op and span:
                break
        key = op or span or "_host_between_ops_"
        by[key] = by.get(key, 0.0) + gap / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
