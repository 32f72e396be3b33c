"""Exact ROIPooling (MXNet v1.1.0 ROIPooling): CUDA kernel and plain version.
Counterpart of relation_tpu/ops/roi_pool.py::roi_pool; the kernel is
csrc/roi_pool.cu (forward: a max over each bin, with its argmax when a
gradient will be asked for; backward: the cotangent added to the argmax
cell with f32 atomics).

The JAX function is plain jnp over a 2-D sparse table of range maxima, with
an integer emulation of f32 division (``_f32_div_int``) because XLA turns a
division by a constant into a multiplication by its reciprocal. Neither is
carried over: a PyTorch division of two f32 tensors is IEEE-exact on both
devices (``f32_div``; a CUDA division by a host scalar is not), and the bins
are walked (kernel) or gathered (plain version) directly. Coordinates round
as C's round() does, half away from zero; the JAX function's
floor(v + copysign(0.5, v)) differs from it one ulp below a half and for
negative coordinates, which clipped proposals never have.

Both versions choose the first maximum of a bin in row-major scan order, so
their argmax, and with it their gradient, agree cell for cell (the JAX
function's autodiff of ``max`` splits a tie). The gradient flows to the
feature map only; the ROIs get none, as with the reference's op.
"""

from __future__ import annotations

import ctypes

import torch

from relation_tpu_torch.ops.kernels import _build

launches = 0          # launches of the forward kernel (CUDA only)
bwd_launches = 0      # launches of the backward kernel (CUDA only)
launch_shapes: dict[str, int] = {}      # forward launches by "H= W= C="
# elements a gathered chunk of the plain version may hold
_PLAIN_CHUNK = 1 << 25


def _c_round(v: torch.Tensor) -> torch.Tensor:
    """C round(): half away from zero, exact in f32 (v - trunc(v) is
    exact)."""
    t = torch.trunc(v)
    return t + torch.sign(v) * (torch.abs(v - t) >= 0.5).to(v.dtype)


def f32_div(n: torch.Tensor, d: int) -> torch.Tensor:
    """IEEE (correctly rounded) f32 of integer n / d. The divisor is a
    tensor on n's device: PyTorch's CUDA division by a host scalar
    multiplies by its reciprocal, which is not correctly rounded
    (fl(21 * fl(1/7)) is 3.0000002, not 3)."""
    n = n.to(torch.float32)
    return n / torch.full_like(n, float(d))


def roi_pool_bins(rois: torch.Tensor, spatial_scale: float, pooled_size: int,
                  H: int, W: int):
    """(hs, he, ws, we), each [R, P] int64: the bin [hs, he) x [ws, we) of
    every ROI and pooled row or column, in the f32 arithmetic of the
    reference's CUDA kernel (csrc/roi_pool.cu::bin_edges)."""
    P = pooled_size
    r = rois.detach().to(torch.float32) * torch.tensor(
        spatial_scale, dtype=torch.float32, device=rois.device)
    start = _c_round(r).to(torch.int64)
    sw, sh, ew, eh = start.unbind(1)
    bw = f32_div(torch.clamp_min(ew - sw + 1, 1), P)
    bh = f32_div(torch.clamp_min(eh - sh + 1, 1), P)
    p = torch.arange(P, dtype=torch.float32, device=rois.device)

    def edges(b, s, size):
        lo = torch.floor(p[None, :] * b[:, None]).to(torch.int64) + s[:, None]
        hi = torch.ceil((p[None, :] + 1) * b[:, None]).to(torch.int64) + s[:, None]
        return lo.clamp(0, size), hi.clamp(0, size)
    hs, he = edges(bh, sh, H)
    ws, we = edges(bw, sw, W)
    return hs, he, ws, we


@torch.no_grad()
def roi_pool_argmax_reference(feat: torch.Tensor, rois: torch.Tensor,
                              spatial_scale: float,
                              pooled_size: int = 7) -> torch.Tensor:
    """argmax [R, P, P, C] int64 of the plain version: h * W + w of each
    bin's first maximum in scan order, -1 for an empty bin. Every bin's
    window is gathered at once, padded to the largest bin, chunked over the
    ROIs."""
    H, W, C = feat.shape
    R, P = rois.shape[0], pooled_size
    dev = feat.device
    hs, he, ws, we = roi_pool_bins(rois, spatial_scale, P, H, W)
    out = torch.full((R, P, P, C), -1, dtype=torch.int64, device=dev)
    if R == 0:
        return out
    kh = max(int((he - hs).max()), 1)
    kw = max(int((we - ws).max()), 1)
    flat = feat.reshape(H * W, C)
    ah, aw = torch.arange(kh, device=dev), torch.arange(kw, device=dev)
    step = max(1, _PLAIN_CHUNK // (P * P * kh * kw * C))
    for lo in range(0, R, step):
        sl = slice(lo, min(lo + step, R))
        ys = hs[sl, :, None] + ah                               # [r, P, kh]
        xs = ws[sl, :, None] + aw                               # [r, P, kw]
        ok = ((ys < he[sl, :, None])[:, :, None, :, None]
              & (xs < we[sl, :, None])[:, None, :, None, :])    # [r, P, P, kh, kw]
        pix = (ys.clamp(max=H - 1)[:, :, None, :, None] * W
               + xs.clamp(max=W - 1)[:, None, :, None, :])
        n = pix.shape[0]
        vals = flat[pix.reshape(-1)].reshape(n, P, P, kh * kw, C)
        vals = torch.where(ok.reshape(n, P, P, kh * kw, 1), vals,
                           torch.full((), float("-inf"), dtype=vals.dtype,
                                      device=dev))
        best = torch.argmax(vals, dim=3)                # first maximum [n, P, P, C]
        cell = torch.gather(pix.reshape(n, P, P, kh * kw), 3, best)
        empty = ~ok.reshape(n, P, P, -1).any(-1)
        out[sl] = torch.where(empty[..., None], -1, cell)
    return out


def _pool_at(feat: torch.Tensor, argmax: torch.Tensor) -> torch.Tensor:
    """feat's values at ``argmax`` (0 where it is -1), differentiable in
    feat: the backward adds the cotangent into the chosen cells."""
    H, W, C = feat.shape
    c = torch.arange(C, device=feat.device)
    idx = argmax.clamp(min=0) * C + c
    vals = feat.reshape(-1)[idx.reshape(-1)].reshape(argmax.shape)
    return torch.where(argmax >= 0, vals, torch.zeros((), dtype=feat.dtype,
                                                      device=feat.device))


def roi_pool_reference(feat: torch.Tensor, rois: torch.Tensor,
                       spatial_scale: float, pooled_size: int = 7) -> torch.Tensor:
    """Plain version: feat [H, W, C], rois [R, 4] -> [R, P, P, C] in feat's
    dtype, differentiable in feat (autograd of the gather)."""
    return _pool_at(feat, roi_pool_argmax_reference(feat, rois, spatial_scale,
                                                    pooled_size))


def _launch(feat, rois, scale: float, P: int, with_argmax: bool = True):
    """(out, argmax int32 or None): the forward kernel; without
    ``with_argmax`` it writes the pooled values only."""
    H, W, C = feat.shape
    R = rois.shape[0]
    out = torch.empty((R, P, P, C), dtype=feat.dtype, device=feat.device)
    argmax = (torch.empty((R, P, P, C), dtype=torch.int32, device=feat.device)
              if with_argmax else None)
    fn = _build.load("roi_pool").roi_pool_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
    _build.check(fn(_build.ptr(feat), int(feat.dtype == torch.bfloat16),
                    _build.ptr(rois), float(scale), R, P, H, W, C,
                    _build.ptr(out),
                    None if argmax is None else _build.ptr(argmax),
                    _build.stream_ptr(feat.device)), "roi_pool_forward")
    return out, argmax


def _launch_bwd(dout, argmax, H: int, W: int):
    C = dout.shape[-1]
    dfeat = torch.zeros((H, W, C), dtype=torch.float32, device=dout.device)
    fn = _build.load("roi_pool").roi_pool_backward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_long, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    _build.check(fn(_build.ptr(dout), int(dout.dtype == torch.bfloat16),
                    _build.ptr(argmax), dout.numel(), C, _build.ptr(dfeat),
                    _build.stream_ptr(dout.device)), "roi_pool_backward")
    return dfeat


def _count(feat) -> None:
    global launches
    launches += 1
    H, W, C = feat.shape
    _build.tally(launch_shapes, f"H={H} W={W} C={C}")


class _RoiPool(torch.autograd.Function):
    """forward = the forward kernel with the argmax; backward = the backward
    kernel over the saved argmax. The ROIs take no gradient."""

    @staticmethod
    def forward(ctx, feat, rois, scale, P):
        out, argmax = _launch(feat, rois, scale, P)
        _count(feat)
        ctx.save_for_backward(argmax)
        ctx.shape, ctx.dtype = tuple(feat.shape), feat.dtype
        ctx.mark_non_differentiable(argmax)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        global bwd_launches
        (argmax,) = ctx.saved_tensors
        if dout.dtype not in (torch.float32, torch.bfloat16):
            dout = dout.float()
        H, W, _ = ctx.shape
        dfeat = _launch_bwd(dout.contiguous(), argmax, H, W)
        bwd_launches += 1
        return dfeat.to(ctx.dtype), None, None, None


def roi_pool(feat: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
             pooled_size: int = 7) -> torch.Tensor:
    """Exact MXNet ROIPooling of one image: feat [H, W, C] (f32 or bf16),
    rois [R, 4] (x1, y1, x2, y2, image coordinates) -> [R, P, P, C] in
    feat's dtype; differentiable in feat. CUDA tensors launch the kernels:
    the forward writes the argmax only when feat requires a gradient under
    grad mode, and the backward kernel runs when the gradient is asked for;
    CPU tensors take the plain version."""
    if feat.device.type != "cuda":
        return roi_pool_reference(feat, rois, spatial_scale, pooled_size)
    if feat.dim() != 3 or rois.dim() != 2 or rois.shape[-1] != 4:
        raise ValueError(f"roi_pool: feat {tuple(feat.shape)}, rois "
                         f"{tuple(rois.shape)}")
    if feat.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"roi_pool: feat of {feat.dtype}")
    feat = feat.contiguous()
    rois = rois.detach().to(torch.float32).contiguous()
    _build.check_inputs("roi_pool", feat, rois)
    return _pool_kernels(feat, rois, float(spatial_scale), int(pooled_size))


def _pool_kernels(feat, rois, scale: float, P: int) -> torch.Tensor:
    """The kernels' route of roi_pool on checked inputs: with the argmax and
    the backward when feat requires a gradient under grad mode, else the
    forward alone without the argmax."""
    if torch.is_grad_enabled() and feat.requires_grad:
        return _RoiPool.apply(feat, rois, scale, P)
    out, _ = _launch(feat, rois, scale, P, with_argmax=False)
    _count(feat)
    return out
