"""Pyramid ROIAlign: CUDA kernel and plain version. Every ROI is pooled
(P x P bins, the mean of S x S bilinear samples a bin) at its own level of a
pyramid of one to four maps, its level picked from its box:

    level = clip(floor(2 + log2(sqrt(w * h) / 224)), 0, levels - 1)

(models/fpn.py::roi_level_dispatch for the FPN head's four levels; a single
map, the C4 head's, takes every ROI). The kernel (csrc/roi_align.cu) picks
the level on the device, block by block, and writes the pooled ROIs in
their order: no host read of the level counts, no sort, no scatter back.

No Pallas counterpart: the JAX package pools with
relation_tpu/ops/roi_pool.py::roi_align_mxu, two dense interpolation
contractions over the whole map (the TPU's form, ops/roi_pool.py keeps it
as the reference of the parity tests). The plain version here is the gather
form (ops/roi_pool.py::roi_align) at every level for every ROI, each ROI's
row kept with ``torch.where``: no host read either, at the cost of pooling
each ROI at every level (cheap at the CPU tests' sizes). Both compute in
f32 and round once to the maps' dtype; the ROIs take no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from relation_tpu_torch.ops.kernels import _build
from relation_tpu_torch.ops.roi_pool import roi_align

launches = 0          # launches of the forward kernel (CUDA only)
bwd_launches = 0      # launches of the backward kernel (CUDA only)
launch_shapes: dict[str, int] = {}      # forward launches by "L= R= C="
MAX_LEVELS = 4        # csrc/roi_align.cu::kMaxLevels
MAX_SAMPLES = 64      # P * S an axis (csrc/roi_align.cu::kMaxSamples)


def roi_levels(rois: torch.Tensor, n_levels: int) -> torch.Tensor:
    """Level [R] int32 of every ROI [R, 4] (image coordinates) in a pyramid
    of ``n_levels`` maps, finest first: clip(floor(2 + log2(sqrt(w*h) /
    224)), 0, n_levels - 1) (reference core/rcnn.py:55)."""
    w = rois[:, 2] - rois[:, 0] + 1.0
    h = rois[:, 3] - rois[:, 1] + 1.0
    s = torch.sqrt(torch.clamp_min(w * h, 1e-6))
    fid = torch.floor(2.0 + torch.log2(s / 224.0))
    return torch.clamp(fid, 0, n_levels - 1).to(torch.int32)


def roi_align_levels_reference(levels, scales, rois: torch.Tensor,
                               pooled_size: int = 7,
                               sampling_ratio: int = 2) -> torch.Tensor:
    """Plain version: ``levels`` [H_l, W_l, C] (finest first), ``scales``
    their 1/stride, rois [R, 4] -> [R, P, P, C] in the levels' dtype,
    differentiable in the levels (autograd of the gathers)."""
    rois = rois.detach().to(torch.float32)
    fid = roi_levels(rois, len(levels))
    out = None
    for i, (feat, scale) in enumerate(zip(levels, scales)):
        pooled = roi_align(feat, rois, scale, pooled_size, sampling_ratio)
        out = pooled if out is None else torch.where(
            (fid == i)[:, None, None, None], pooled, out)
    return out.to(levels[0].dtype)


def _table(shapes, scales):
    """The level table of the C entry points: (n, sizes [2n] int, scales
    [n] f32) as ctypes arrays."""
    n = len(shapes)
    sizes = (ctypes.c_int * (2 * n))(*[d for s in shapes for d in s[:2]])
    sc = (ctypes.c_float * n)(*[float(s) for s in scales])
    return n, sizes, sc


def _launch(levels, scales, rois, P: int, S: int) -> torch.Tensor:
    """The forward kernel: the pooled ROIs [R, P, P, C] in the levels'
    dtype."""
    f0 = levels[0]
    C, R = f0.shape[2], rois.shape[0]
    out = torch.empty((R, P, P, C), dtype=f0.dtype, device=f0.device)
    n, sizes, sc = _table([f.shape for f in levels], scales)
    feats = (ctypes.c_void_p * n)(*[f.data_ptr() for f in levels])
    strides = (ctypes.c_longlong * (3 * n))(*[s for f in levels
                                              for s in f.stride()])
    fn = _build.load("roi_align").roi_align_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    _build.check(fn(n, feats, strides, sizes, sc, C,
                    int(f0.dtype == torch.bfloat16), _build.ptr(rois), R, P, S,
                    _build.ptr(out), _build.stream_ptr(f0.device)),
                 "roi_align_forward")
    return out


def _launch_bwd(dout, rois, shapes, scales, P: int, S: int, wanted):
    """The backward kernel: d_feat [H_l, W_l, C] f32 of every level whose
    ``wanted`` is true (None for the others)."""
    C, R = dout.shape[-1], rois.shape[0]
    grads = [torch.zeros((h, w, C), dtype=torch.float32, device=dout.device)
             if want else None for (h, w, _), want in zip(shapes, wanted)]
    n, sizes, sc = _table(shapes, scales)
    ptrs = (ctypes.c_void_p * n)(*[None if g is None else g.data_ptr()
                                   for g in grads])
    fn = _build.load("roi_align").roi_align_backward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    _build.check(fn(n, ptrs, sizes, sc, C, int(dout.dtype == torch.bfloat16),
                    _build.ptr(dout), _build.ptr(rois), R, P, S,
                    _build.stream_ptr(dout.device)), "roi_align_backward")
    return grads


def _count(levels, rois) -> None:
    _build.count(globals(), "launches", "launch_shapes",
                 f"L={len(levels)} R={rois.shape[0]} C={levels[0].shape[2]}")


class _RoiAlign(torch.autograd.Function):
    """forward = the forward kernel; backward = the backward kernel, for the
    levels that ask for a gradient (it needs the ROIs alone: ROIAlign is
    linear in the maps). The ROIs take no gradient."""

    @staticmethod
    def forward(ctx, rois, scales, P, S, *levels):
        out = _launch(levels, scales, rois, P, S)
        _count(levels, rois)
        ctx.save_for_backward(rois)
        ctx.meta = (scales, P, S, [tuple(f.shape) for f in levels],
                    levels[0].dtype)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        (rois,) = ctx.saved_tensors
        scales, P, S, shapes, dtype = ctx.meta
        if dout.dtype not in (torch.float32, torch.bfloat16):
            dout = dout.float()
        grads = _launch_bwd(dout.contiguous(), rois, shapes, scales, P, S,
                            ctx.needs_input_grad[4:])
        _build.count(globals(), "bwd_launches")
        return (None, None, None, None,
                *[None if g is None else g.to(dtype) for g in grads])


def roi_align_levels(levels, scales, rois: torch.Tensor, pooled_size: int = 7,
                     sampling_ratio: int = 2) -> torch.Tensor:
    """ROIAlign of every ROI at its own level: ``levels`` a sequence of one
    to four maps [H_l, W_l, C] of one dtype (f32 or bf16), finest first,
    ``scales`` their 1/stride, rois [R, 4] (x1, y1, x2, y2, image
    coordinates) -> [R, P, P, C] in the maps' dtype, differentiable in the
    maps. CUDA tensors launch the kernels (each map made channels-last
    first: a strided map is copied once, so that a warp's loads coalesce);
    CPU tensors take the plain version."""
    levels = list(levels)
    if levels[0].device.type != "cuda":
        return roi_align_levels_reference(levels, scales, rois, pooled_size,
                                          sampling_ratio)
    if not 1 <= len(levels) <= MAX_LEVELS or len(scales) != len(levels):
        raise ValueError(f"roi_align_levels: {len(levels)} levels, "
                         f"{len(scales)} scales (1 to {MAX_LEVELS})")
    C, dt = levels[0].shape[-1], levels[0].dtype
    if any(f.dim() != 3 or f.shape[2] != C or f.dtype != dt for f in levels):
        raise ValueError("roi_align_levels: levels of "
                         f"{[(tuple(f.shape), f.dtype) for f in levels]}")
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"roi_align_levels: levels of {dt}")
    if rois.dim() != 2 or rois.shape[-1] != 4:
        raise ValueError(f"roi_align_levels: rois {tuple(rois.shape)}")
    P, S = int(pooled_size), int(sampling_ratio)
    if P < 1 or S < 1 or P * S > MAX_SAMPLES:
        raise ValueError(f"roi_align_levels: P={P}, S={S}")
    levels = [f.contiguous() for f in levels]
    rois = rois.detach().to(torch.float32).contiguous()
    _build.check_inputs("roi_align_levels", *levels, rois)
    return _RoiAlign.apply(rois, tuple(float(s) for s in scales), P, S,
                           *levels)
