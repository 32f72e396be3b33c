"""A train step's target assignment and proposals replayed as CUDA graphs.

Those stages make no autograd graph, read nothing on the host and, handed
their random priorities, draw nothing: a few hundred small launches an
image whose host time paces the step while the card waits for them.
``replayed(fn)`` runs such a function of tensors once as it is, captures it
as a CUDA graph for that signature (the arguments' shapes, dtypes and
devices) and thereafter copies the arguments into the graph's buffers and
replays it: the same kernels with the same arguments, so the same bits,
from one launch. The outputs are copied out, so that the next replay does
not overwrite them, and the launch counters of ops/kernels move by what
the capturing thread counted in the capture (a replay launches those
kernels again).
Arguments that are not all CUDA tensors run ``fn`` as it is (the CPU, host
data), and so does a signature whose capture fails, with a warning: a
plain version put behind a kernel launcher on the card, which reads the
host, cannot be captured.
"""

from __future__ import annotations

import importlib
import warnings

import torch

from relation_tpu_torch.ops.kernels import _build


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def _add_launches(added: dict, sign: int = 1) -> None:
    """Add ``sign`` times ``_build.noting``'s counts to the counters."""
    for k, d in added.items():
        name, attr = k.split(".")
        mod = importlib.import_module(f"relation_tpu_torch.ops.kernels.{name}")
        if isinstance(d, dict):
            shapes = getattr(mod, attr)
            for s, n in d.items():
                shapes[s] = shapes.get(s, 0) + sign * n
        else:
            setattr(mod, attr, getattr(mod, attr) + sign * d)


def _capture(fn, args):
    """(input buffers, outputs, graph, launches added a call) of ``fn`` on
    copies of ``args``, after one run outside the capture (kernel builds,
    lazy library state); None where the capture fails."""
    dev = args[0].device
    static_in = [a.detach().clone() for a in args]
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn(*static_in)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # the launch counters move by what this thread launches in the capture
    # (``noting``), not by what other threads launch meanwhile
    with _build.noting() as added:
        try:
            # thread_local: a loader thread's CUDA calls stay legal meanwhile
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                static_out = fn(*static_in)
        except RuntimeError as err:
            failed = err
        else:
            failed = None
    _add_launches(added, -1)        # the capture itself launched nothing
    if failed is not None:
        torch.cuda.synchronize(dev)
        warnings.warn(f"{getattr(fn, '__qualname__', fn)} runs without a CUDA "
                      f"graph: {failed}")
        return None
    return static_in, static_out, graph, added


def replayed(fn):
    """``fn(*tensors)``, no gradient, as a CUDA graph per argument signature
    (see the module docstring); ``fn`` must not draw random numbers, read a
    value on the host or depend on anything but its arguments and
    constants."""
    graphs = {}

    @torch.no_grad()
    def run(*args):
        if not all(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
            return fn(*args)
        key = tuple((a.shape, a.dtype, a.device) for a in args)
        if key not in graphs:
            graphs[key] = _capture(fn, args)
        if graphs[key] is None:
            return fn(*args)
        static_in, static_out, graph, added = graphs[key]
        for buf, a in zip(static_in, args):
            buf.copy_(a)
        graph.replay()
        _add_launches(added)
        return _map(torch.clone, static_out)
    return run
