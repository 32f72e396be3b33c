"""What every driver shares: the program's config from a configuration
file, the CPU rehearsal's small shapes, precision switches, the device's
clock and memory, the program's span-and-counter registry, and the result
line."""

from __future__ import annotations

import copy
import json
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "relation_tpu")


def program_cfg(config: dict, rehearse: bool = False):
    """The port's config of the configuration's family
    (relation_tpu_torch.entry.family_cfg) with the file's ``program_cfg``
    keys set on it ("SECTION.KEY": value)."""
    from relation_tpu_torch.entry import family_cfg
    cfg = family_cfg(config["family"], tiny_shapes=rehearse)
    for dotted, value in config["program_cfg"].items():
        *path, key = dotted.split(".")
        node = cfg
        for part in path:
            node = getattr(node, part)
        setattr(node, key, value)
    return cfg


def build_kernels(device) -> None:
    """Build every CUDA kernel of the port before the first request (its
    libraries are built on first use, one file each; two threads asking
    for one at once would race), from the fixed build directory inside the
    checkout, where a later run finds them built."""
    if device.type == "cuda":
        from relation_tpu_torch.ops.kernels import _build
        _build.build_all()


def set_precision(precision: str) -> None:
    """float32 as stated: no TF32 in matrix products or convolutions."""
    import torch
    if precision != "float32":
        raise ValueError(f"precision {precision!r}: this harness runs float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rehearsal(config: dict, mix: dict):
    """Copies of a configuration and a mix cut for a CPU rehearsal: a small
    image, the port's tiny proposal counts (family_cfg(tiny_shapes=True)),
    few ROIs, gt boxes, batches, images and requests."""
    c, m = copy.deepcopy(config), copy.deepcopy(mix)
    c["images"] = {"bucket": [64, 128], "sizes": [[64, 128, 1.0], [60, 112, 1.0]]}
    for sec in ("train", "test"):
        c[sec].update(rpn_pre_nms_top_n=128, rpn_post_nms_top_n=48, first_n=16)
    small = {"rois_per_image": 40, "gt_counts": [1, 2, 3], "batch_images": 2,
             "pool_batches": 4, "pool_images": 6, "check_requests": 3,
             "warm_requests": 1, "trace_seconds": 1}
    m.update({k: v for k, v in small.items() if k in m})
    return c, m


def sync(ctx) -> None:
    if ctx["device"].type == "cuda":
        import torch
        torch.cuda.synchronize()


def max_mem(ctx) -> int:
    import torch
    return torch.cuda.max_memory_allocated() if ctx["device"].type == "cuda" else 0


def reset_mem(ctx) -> None:
    if ctx["device"].type == "cuda":
        import torch
        torch.cuda.reset_peak_memory_stats()


def program_registry(ctx):
    """The program's span-and-counter registry (relation_tpu_torch/utils/
    trace.py), enabled, where ``ctx["trace"]`` holds; else None, and the
    registry stays as it is (off, as the program leaves it)."""
    if not ctx["trace"]:
        return None
    from relation_tpu_torch.utils import trace as registry
    registry.enable()
    return registry


def setup_snapshot(registry):
    """The registry's snapshot of the set-up, then a reset, and the
    registry off: the window and the first traced window then run as in an
    untraced run, with no ``rn:`` records in the trace. None without the
    registry."""
    if registry is None:
        return None
    snap = registry.snapshot()
    registry.reset()
    registry.disable()
    return snap


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({n for n in sys.modules if n.split(".", 1)[0] in FORBIDDEN})


def emit(result: dict, checks: dict) -> None:
    """The checks as the last lines of standard error, then the result line
    as the last line of standard output with the checks under the last
    key."""
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    out = dict(result)
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    print(json.dumps(out), flush=True)
