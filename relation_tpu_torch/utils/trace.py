"""Spans and counters of relation_tpu_torch: the port's one registry of where
its host time goes and of what it counts.

    from relation_tpu_torch.utils import trace

    with trace.span("predict.head"):      # or @trace.span("setup.model")
        ...
    trace.count("host_read.fpn_level_counts")

Off by default. Off, a span or a count tests one flag and calls nothing in
torch. ``enable()`` turns the registry on for the process; then

- a span adds its host-clock duration to its name's totals (count, total,
  max, and the first one after the last ``reset()``). Each span keeps its
  own start, so spans nest on every thread (the serving clients call from
  threads of their own);
- while a ``torch.profiler`` session records, a span also opens
  ``torch.profiler.record_function("rn:" + name)``, so that it sits in the
  device trace on the profiler's clock beside the kernels launched under
  it. A span made with ``request=True`` (the outer ``predict`` and ``step``)
  carries a sequence number of the process in the record's args: the
  spans of one request share it;
- a count adds to its name's counter.

``snapshot()`` gives the spans and counters since the last ``reset()``,
the kernel launch counters of ops/kernels (``kernel_launches()``, whole
process) and, once CUDA is initialised, the caching allocator's device
allocations and retries since the last ``reset()``.

The span names are the stages the benchmark's stage reduction reads
(benchmark/harness/stages.py): ``predict`` and ``predict.{input,trunk_rpn,
proposals,head,tail}`` (core/predictor.py), ``step`` and ``step.{input,
trunk_rpn,rois,backward,allreduce,update}`` (core/trainer.py::run_step),
``setup.kernels`` (ops/kernels/_build.py) and ``setup.model``
(core/trainer.py::build_model); a DCN model also opens ``dcn.conv`` (a
deformable res5 unit's offset conv and deformable conv, models/backbone.py),
``dcn.pool`` (the head's two deformable PSROI pools and its ``offset`` FC,
models/detector.py), and in the deformable conv's backward, on autograd's
thread, ``dcn.conv_bwd`` around ``dcn.col2im`` (ops/deform.py). The
counters are the program's deliberate host reads of device data
(``host_read.<site>``), the learned-NMS attention's branch
(``lnms.branch.<skip|dense|fused>``), the kernel libraries built and
loaded (``kernels.built``, ``kernels.loaded``) and the deformable ops'
bilinear samples, counted from shapes (``dcn.conv.samples``: B * Ho * Wo *
taps * groups a conv; ``dcn.pool.samples``: ROIs * bins * samples a bin a
pool).
"""

from __future__ import annotations

import functools
import itertools
import threading
import time

import torch

PREFIX = "rn:"

_on = False
_lock = threading.Lock()
_spans: dict[str, list] = {}        # name -> [count, total_s, max_s, first_s]
_counts: dict[str, int] = {}
_alloc_base: dict[str, int] = {}
_requests = itertools.count()
ALLOC_STATS = ("num_device_alloc", "num_alloc_retries")


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def reset() -> None:
    """Forget the spans and counters, and take the allocator's counts from
    here on."""
    with _lock:
        _spans.clear()
        _counts.clear()
        _alloc_base.clear()
        _alloc_base.update(_allocator())


def count(name: str, n: int = 1) -> None:
    if _on:
        with _lock:
            _counts[name] = _counts.get(name, 0) + n


class span:
    """A named span: a context manager, or a decorator that opens one
    around each call of the function."""

    __slots__ = ("name", "request", "_t0", "_record")

    def __init__(self, name: str, request: bool = False):
        self.name, self.request = name, request
        self._t0 = None

    def __enter__(self):
        if _on:
            # the Python flag of every profiler session: the C++ check
            # reads False under a session that records all threads
            if torch.autograd.profiler._is_profiler_enabled:
                self._record = torch.profiler.record_function(
                    PREFIX + self.name,
                    str(next(_requests)) if self.request else None)
                self._record.__enter__()
            else:
                self._record = None
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._t0 is None:
            return False
        dt = time.perf_counter() - self._t0
        self._t0 = None
        if self._record is not None:
            self._record.__exit__(*exc)
        with _lock:
            row = _spans.get(self.name)
            if row is None:
                _spans[self.name] = [1, dt, dt, dt]
            else:
                row[0] += 1
                row[1] += dt
                row[2] = max(row[2], dt)
        return False

    def __call__(self, fn):
        name, request = self.name, self.request

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name, request):
                return fn(*args, **kwargs)
        return inner


def kernel_launches() -> dict:
    """{"module.counter": value} of every launch counter of ops/kernels (the
    integers named *launches, and the dicts of launches by shape named
    *launch_shapes) in this process."""
    import importlib
    import pkgutil
    import relation_tpu_torch.ops.kernels as kernels
    out = {}
    for info in pkgutil.iter_modules(kernels.__path__):
        if info.name.startswith("_"):
            continue
        mod = importlib.import_module(f"{kernels.__name__}.{info.name}")
        for attr, v in vars(mod).items():
            if attr.endswith("launches") and isinstance(v, int):
                out[f"{info.name}.{attr}"] = v
            elif attr.endswith("launch_shapes") and isinstance(v, dict):
                out[f"{info.name}.{attr}"] = dict(v)
    return out


def _allocator() -> dict:
    """The caching allocator's ALLOC_STATS, {} before CUDA is initialised."""
    if not torch.cuda.is_initialized():
        return {}
    stats = torch.cuda.memory_stats()
    return {k: int(stats.get(k, 0)) for k in ALLOC_STATS}


def snapshot() -> dict:
    """{"spans": {name: {"count", "total_s", "max_s", "first_s"}},
    "counters": {name: value}, "launches": kernel_launches(),
    "allocator": {stat: growth since the last reset()}}; "allocator" only
    once CUDA is initialised."""
    with _lock:
        spans = {k: dict(zip(("count", "total_s", "max_s", "first_s"), v))
                 for k, v in _spans.items()}
        counters = dict(_counts)
        base = dict(_alloc_base)
    out = {"spans": spans, "counters": counters, "launches": kernel_launches()}
    alloc = _allocator()
    if alloc:
        out["allocator"] = {k: v - base.get(k, 0) for k, v in alloc.items()}
    return out
