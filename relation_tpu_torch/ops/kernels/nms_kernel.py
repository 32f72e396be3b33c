"""Exact greedy-NMS keep mask over score-sorted boxes: CUDA kernel and plain
version. Port of relation_tpu/ops/pallas/nms_kernel.py::nms_keep_sorted; the
kernel is csrc/nms_kernel.cu (one launch: a cluster of blocks a class walks
the boxes chunk by chunk, testing each chunk against the boxes kept so far).

Semantics shared by both versions and the TPU kernel: boxes are in descending
score order, IoU uses the +1 width convention and the divide-free test
``inter > thresh * union``, a box is suppressed only by earlier KEPT boxes,
invalid boxes are never kept and never suppress, and the sweep stops at the
first ``block`` boundary at which ``max_keep`` boxes are kept (later boxes 0).
"""

from __future__ import annotations

import ctypes

import torch

from relation_tpu_torch.ops.kernels import _build
from relation_tpu_torch.utils import trace

launches = 0          # kernel launches of nms_keep_sorted (CUDA only)
launch_shapes: dict[str, int] = {}   # its launches by "C= Np="


def _suppress(a, b, thresh_t):
    """a: [..., T, 1] / b: [..., 1, N] planar tuples (x1, y1, x2, y2, area)
    -> [..., T, N] bool: IoU(a, b) > thresh, divide-free."""
    iw = (torch.minimum(a[2], b[2]) - torch.maximum(a[0], b[0]) + 1.0).clamp_min(0.0)
    ih = (torch.minimum(a[3], b[3]) - torch.maximum(a[1], b[1]) + 1.0).clamp_min(0.0)
    inter = iw * ih
    return inter > thresh_t * (a[4] + b[4] - inter)


def nms_keep_sorted_reference(boxesT: torch.Tensor, valid: torch.Tensor,
                              thresh: float, block: int = 256,
                              max_keep: int | None = None) -> torch.Tensor:
    """Plain version: the blocked fixpoint of relation_tpu/ops/nms.py
    (block-vs-prefix suppression, then the triangular intra-block recurrence
    iterated to its fixpoint), batched over classes.
    boxesT [C, 4, N] f32, valid [C, N] -> keep [C, N] f32."""
    C, _, N = boxesT.shape
    if N % block:
        raise ValueError(f"N={N} must be a multiple of block={block}")
    cap = N if max_keep is None else int(max_keep)
    x1, y1, x2, y2 = boxesT.unbind(1)
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    planes = (x1, y1, x2, y2, area)
    thresh_t = torch.tensor(thresh, dtype=boxesT.dtype, device=boxesT.device)
    valid_b = valid > 0
    keep = torch.zeros((C, N), dtype=torch.bool, device=boxesT.device)
    kept = torch.zeros((C,), dtype=torch.long, device=boxesT.device)
    col = torch.arange(N, device=boxesT.device)
    upper = torch.triu(torch.ones((block, block), dtype=torch.bool,
                                  device=boxesT.device), diagonal=1)
    for lo in range(0, N, block):
        live = kept < cap                                  # [C]
        trace.count("host_read.nms_live")
        if not bool(live.any()):
            break
        blk = tuple(p[:, lo:lo + block, None] for p in planes)   # [C, T, 1]
        sup = _suppress(blk, tuple(p[:, None, :] for p in planes), thresh_t)
        prefix = keep & (col < lo)                         # [C, N]
        sup_prev = (sup & prefix[:, None, :]).any(-1)      # [C, T]
        seed = valid_b[:, lo:lo + block] & ~sup_prev & live[:, None]
        sub = sup[:, :, lo:lo + block] & upper             # i suppresses j > i
        active = seed
        for _ in range(block):
            nxt = seed & ~(active[:, :, None] & sub).any(1)
            if torch.equal(nxt, active):
                break
            active = nxt
        keep[:, lo:lo + block] = active
        kept += active.sum(1)
    return keep.to(torch.float32)


def launch(boxesT: torch.Tensor, valid: torch.Tensor, thresh: float,
           block: int, cap: int) -> torch.Tensor:
    """The kernel, one launch: keep [C, N] f32. Raises, launching nothing,
    when the walk could keep more boxes a class than the kernel's kept list
    holds (1024 boxes a block of the class's cluster)."""
    C, _, N = boxesT.shape
    keep = torch.empty((C, N), dtype=torch.float32, device=boxesT.device)
    fn = _build.load("nms_kernel").nms_keep
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p]
    rc = fn(_build.ptr(boxesT), _build.ptr(valid), _build.ptr(keep), C, N,
            int(block), int(cap), float(thresh), _build.stream_ptr(boxesT.device))
    if rc < 0:
        raise ValueError(
            f"nms_keep_sorted: up to {min(N, cap + block - 1)} kept boxes a "
            f"class (N={N}, max_keep={cap}, block={block}), more than the "
            f"kernel's kept list holds at C={C} ({-rc}); pass a smaller "
            "max_keep")
    _build.check(rc, "nms_keep")
    return keep


def nms_keep_sorted(boxesT: torch.Tensor, valid: torch.Tensor, thresh: float,
                    block: int = 256, max_keep: int | None = None) -> torch.Tensor:
    """Batched greedy-NMS keep mask. boxesT [C, 4, N] f32 sorted by
    descending score, N a multiple of ``block`` (on the card a multiple of
    64); valid [C, N] f32.
    Returns keep [C, N] f32. CUDA tensors launch the kernel; CPU tensors
    take the plain version. The mask has no gradient: on the card an input
    that requires one is refused."""
    if boxesT.device.type != "cuda":
        return nms_keep_sorted_reference(boxesT, valid, thresh, block, max_keep)
    C, four, N = boxesT.shape
    if four != 4 or valid.shape != (C, N) or N % block or block % 64:
        raise ValueError(f"nms_keep_sorted: shapes {tuple(boxesT.shape)}, "
                         f"{tuple(valid.shape)}, block {block}")
    if boxesT.dtype != torch.float32 or valid.dtype != torch.float32:
        raise TypeError("nms_keep_sorted: expects float32 boxes and valid")
    _build.check_inputs("nms_keep_sorted", boxesT, valid)
    if boxesT.data_ptr() % 16 or valid.data_ptr() % 16:
        raise ValueError("nms_keep_sorted: the kernel copies 16-byte pieces; "
                         "boxesT and valid must start 16-byte aligned")
    _build.refuse_grad("nms_keep_sorted", boxesT, valid)
    cap = N if max_keep is None else int(max_keep)
    keep = launch(boxesT, valid, thresh, block, cap)
    _build.count(globals(), "launches", "launch_shapes",
                 f"C={C} Np={N}")
    return keep
