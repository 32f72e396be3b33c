"""Fused geometric attention bias, forward and backward: CUDA kernels and
plain versions.

    bias[c, g, n, m] = log(max(sincos_emb(100 * pos[c, :, n, m]) @ W + b, 1e-6))

with the reference's sinusoid embedding (4 fields x 8 frequencies x {sin, cos},
feature layout j*16 + (sin 0-7 | cos 8-15)) and W/b the pair_pos_fc1 dense.
Port of relation_tpu/ops/pallas/geom_bias.py::fused_geometric_bias, its
VJP ``_geom_bias_bwd_impl`` and ``fused_geometric_bias_skip`` (the forward
over the active classes only, inference); the kernels are csrc/geom_bias.cu
and csrc/geom_bias_bwd.cu. The op saves only its inputs: the backward
recomputes the sin/cos.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from relation_tpu_torch.ops.kernels import _build
from relation_tpu_torch.utils import trace

launches = 0          # launches of the forward kernel (CUDA only)
bwd_launches = 0      # launches of the backward kernel (CUDA only)
skip_launches = 0     # launches of the class-skipping forward (CUDA only)
launch_shapes: dict[str, int] = {}      # forward launches by "C= N= M="
bwd_launch_shapes: dict[str, int] = {}  # backward launches by "C= N= M="
_SUPPORTED_G = (4, 8, 16, 32)


def _frequencies(wave_length: float = 1000.0) -> np.ndarray:
    """1/lambda_k for k=0..7 (reference dim_mat, feat_dim=64, 4 fields)."""
    k = np.arange(8, dtype=np.float64)
    return (1.0 / np.power(wave_length, (8.0 / 64.0) * k)).astype(np.float32)


# the plain versions' copy, made once: they run on the CPU, where .to() of a
# CPU tensor is the tensor itself (no tensor built from host data a call)
_FREQS = torch.from_numpy(_frequencies())


def _trig(pos_t: torch.Tensor, scale: float) -> torch.Tensor:
    """[C, 4, N, M] -> the sinusoid embedding [C, 64, N, M]."""
    freqs = _FREQS.to(pos_t.device)
    div = pos_t[:, :, None, :, :] * scale * freqs[None, None, :, None, None]
    emb = torch.cat([torch.sin(div), torch.cos(div)], dim=2)   # [C, 4, 16, N, M]
    C, _, _, N, M = emb.shape
    return emb.reshape(C, 64, N, M)


def geom_acc_reference(pos_t: torch.Tensor, kernel: torch.Tensor,
                       bias: torch.Tensor, scale: float = 100.0) -> torch.Tensor:
    """The value under the clamp: sincos_emb(scale * pos) @ W + b,
    [C, G, N, M]."""
    acc = torch.einsum("cfnm,fg->cgnm", _trig(pos_t, scale), kernel)
    return acc + bias[None, :, None, None]


def geom_bias_reference(pos_t: torch.Tensor, kernel: torch.Tensor,
                        bias: torch.Tensor, scale: float = 100.0) -> torch.Tensor:
    """Plain version: [C, 4, N, M], W [64, G], b [G] -> [C, G, N, M]
    (relation_tpu geom_bias_reference with f32 embedding)."""
    return torch.log(torch.clamp_min(
        geom_acc_reference(pos_t, kernel, bias, scale), 1e-6))


def geom_bias_skip_reference(pos_t: torch.Tensor, kernel: torch.Tensor,
                             bias: torch.Tensor, active: torch.Tensor,
                             scale: float = 100.0) -> torch.Tensor:
    """Plain version of the class-skipping forward: the rows of the classes
    with ``active`` [C] != 0 as ``geom_bias_reference`` computes them, zeros
    elsewhere."""
    C, _, N, M = pos_t.shape
    trace.count("host_read.skip_classes")
    idx = torch.nonzero(active != 0).flatten()
    out = torch.zeros((C, kernel.shape[1], N, M), dtype=torch.float32,
                      device=pos_t.device)
    out[idx] = geom_bias_reference(pos_t[idx], kernel, bias, scale)
    return out


def geom_bias_bwd_reference(pos_t: torch.Tensor, kernel: torch.Tensor,
                            bias: torch.Tensor, gout: torch.Tensor,
                            scale: float = 100.0):
    """Plain version of the backward, the formulas of the TPU kernel written
    out step by step (not autograd of the forward): cotangent gout
    [C, G, N, M] -> (d_pos [C, 4, N, M], d_W [64, G], d_b [G])."""
    freqs = _FREQS.to(pos_t.device)
    trig = _trig(pos_t, scale)                                  # [C, 64, N, M]
    acc = torch.einsum("cfnm,fg->cgnm", trig, kernel) \
        + bias[None, :, None, None]
    d_acc = torch.where(acc > 1e-6, gout / torch.clamp_min(acc, 1e-6),
                        torch.zeros_like(acc))
    d_w = torch.einsum("cfnm,cgnm->fg", trig, d_acc)
    d_b = d_acc.sum(dim=(0, 2, 3))
    d_trig = torch.einsum("fg,cgnm->cfnm", kernel, d_acc)
    C, _, N, M = pos_t.shape
    trig5, d_trig5 = (x.reshape(C, 4, 2, 8, N, M) for x in (trig, d_trig))
    sin, cos = trig5[:, :, 0], trig5[:, :, 1]                   # [C, 4, 8, N, M]
    d_sin, d_cos = d_trig5[:, :, 0], d_trig5[:, :, 1]
    d_pos = scale * ((cos * d_sin - sin * d_cos)
                     * freqs[None, None, :, None, None]).sum(dim=2)
    return d_pos, d_w, d_b


def _check(name, pos_t, kernel, bias, *more):
    C, four, N, M = pos_t.shape
    G = kernel.shape[1]
    if four != 4 or kernel.shape[0] != 64 or bias.shape != (G,):
        raise ValueError(f"{name}: shapes {tuple(pos_t.shape)}, "
                         f"{tuple(kernel.shape)}, {tuple(bias.shape)}")
    if G not in _SUPPORTED_G:
        raise ValueError(f"{name}: G={G} not in {_SUPPORTED_G}")
    for t in (pos_t, kernel, bias, *more):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expects float32, got {t.dtype}")
    _build.check_inputs(name, pos_t, kernel, bias, *more)
    return C, G, N, M


def _launch(pos_t, kernel, bias, scale, raw: bool = False, active=None):
    """The forward kernel; ``raw`` gives acc + b before the clamp and the log
    (the card tests compare the backward's clamp decisions with it);
    ``active`` [C] computes those classes only and leaves the other rows
    unwritten."""
    name = "geom_bias_skip" if active is not None else "geom_bias"
    C, G, N, M = _check(name, pos_t, kernel, bias)
    out = torch.empty((C, G, N, M), dtype=torch.float32, device=pos_t.device)
    lib = _build.load("geom_bias")
    ptrs = [_build.ptr(pos_t), _build.ptr(kernel), _build.ptr(bias)]
    if active is not None:
        if active.shape != (C,):
            raise ValueError(f"{name}: active {tuple(active.shape)} for C={C}")
        act = active.to(torch.int32).contiguous()
        _build.check_inputs(name, pos_t, act)
        fn, ptrs = lib.geom_bias_fwd_skip, ptrs + [_build.ptr(act)]
    else:
        fn = lib.geom_bias_acc if raw else lib.geom_bias_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * (len(ptrs) + 1) + [
        ctypes.c_int, ctypes.c_int, ctypes.c_long, ctypes.c_float,
        ctypes.c_void_p]
    rc = fn(*ptrs, _build.ptr(out), C, G, N * M, float(scale),
            _build.stream_ptr(pos_t.device))
    _build.check(rc, name)
    return out


def _launch_bwd(pos_t, kernel, bias, gout, scale, need_pos: bool = True,
                want_acc: bool = False):
    """The backward kernel: (d_pos or None, d_W [64, G], d_b [G]); with
    ``want_acc`` also the acc + b it recomputed, [C, G, N, M]."""
    C, G, N, M = _check("geom_bias_bwd", pos_t, kernel, bias, gout)
    if gout.shape != (C, G, N, M):
        raise ValueError(f"geom_bias_bwd: cotangent {tuple(gout.shape)} for "
                         f"an output {(C, G, N, M)}")
    dev = pos_t.device
    dwb = torch.empty((65, G), dtype=torch.float32, device=dev)
    if C * N * M == 0:
        dwb.zero_()
        d_pos = torch.zeros_like(pos_t) if need_pos else None
        return (d_pos, dwb[:64], dwb[64]) + ((torch.empty_like(gout),)
                                             if want_acc else ())
    lib = _build.load("geom_bias_bwd")
    grid = lib.geom_bias_bwd_blocks
    grid.restype = ctypes.c_int
    grid.argtypes = [ctypes.c_int, ctypes.c_long, ctypes.c_void_p]
    blocks = ctypes.c_int(0)
    with torch.cuda.device(dev):
        _build.check(grid(G, C * N * M, ctypes.byref(blocks)),
                     "geom_bias_bwd_blocks")
    partial = torch.empty((blocks.value, 65, G), dtype=torch.float32, device=dev)
    d_pos = torch.empty_like(pos_t) if need_pos else None
    acc = torch.empty_like(gout) if want_acc else None
    fn = lib.geom_bias_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_long, ctypes.c_float,
                                           ctypes.c_int, ctypes.c_void_p]
    null = ctypes.c_void_p(None)
    rc = fn(_build.ptr(pos_t), _build.ptr(kernel), _build.ptr(bias),
            _build.ptr(gout), null if d_pos is None else _build.ptr(d_pos),
            null if acc is None else _build.ptr(acc), _build.ptr(partial),
            _build.ptr(dwb), C, G, N * M, float(scale), blocks.value,
            _build.stream_ptr(dev))
    _build.check(rc, "geom_bias_bwd")
    return (d_pos, dwb[:64], dwb[64]) + ((acc,) if want_acc else ())


def _shape_key(pos_t) -> str:
    C, _, N, M = pos_t.shape
    return f"C={C} N={N} M={M}"


class _GeomBias(torch.autograd.Function):
    """forward = the forward kernel, backward = the backward kernel; only
    (pos, W, b) are saved. The cotangent may arrive non-contiguous (the head
    permutes the bias): it is made contiguous here, not in the kernel."""

    @staticmethod
    def forward(ctx, pos_t, kernel, bias, scale):
        out = _launch(pos_t.contiguous(), kernel.contiguous(),
                      bias.contiguous(), scale)
        _build.count(globals(), "launches", "launch_shapes",
                     _shape_key(pos_t))
        ctx.save_for_backward(pos_t, kernel, bias)
        ctx.scale = scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        pos_t, kernel, bias = ctx.saved_tensors
        d_pos, d_w, d_b = _launch_bwd(
            pos_t.contiguous(), kernel.contiguous(), bias.contiguous(),
            gout.contiguous(), ctx.scale, need_pos=ctx.needs_input_grad[0])[:3]
        _build.count(globals(), "bwd_launches", "bwd_launch_shapes",
                     _shape_key(pos_t))
        return d_pos, d_w, d_b, None


def fused_geometric_bias(pos_t: torch.Tensor, kernel: torch.Tensor,
                         bias: torch.Tensor, scale: float = 100.0) -> torch.Tensor:
    """[C, 4, N, M] geometry, W [64, G], b [G] -> [C, G, N, M] f32 bias,
    differentiable in all three. CUDA tensors launch the kernels (forward,
    and the backward kernel when a gradient is asked for); CPU tensors take
    the plain version, which autograd differentiates."""
    if pos_t.device.type != "cuda":
        return geom_bias_reference(pos_t, kernel, bias, scale)
    return _GeomBias.apply(pos_t, kernel, bias, float(scale))


def fused_geometric_bias_skip(pos_t: torch.Tensor, kernel: torch.Tensor,
                              bias: torch.Tensor, active: torch.Tensor,
                              scale: float = 100.0) -> torch.Tensor:
    """``fused_geometric_bias`` for the classes with ``active`` [C] != 0
    only (the learned-NMS head's inference class filter). On the card the
    other classes' rows are left unwritten, as on the TPU, and an active
    class's rows are bit-equal to the unskipped kernel's; CPU tensors take
    the plain version (zeros there). Inference only: on the card an input
    that requires a gradient is refused, never answered detached."""
    if pos_t.device.type != "cuda":
        return geom_bias_skip_reference(pos_t, kernel, bias, active, scale)
    _build.refuse_grad("fused_geometric_bias_skip", pos_t, kernel, bias)
    out = _launch(pos_t.contiguous(), kernel.contiguous(), bias.contiguous(),
                  scale, active=active)
    _build.count(globals(), "skip_launches")
    return out
