"""Fused conv1 stem (s2d im2col + GEMM + folded BN + ReLU, bf16 out): CUDA
kernel and plain version. Port of relation_tpu/ops/pallas/stem.py::
stem_conv1_bn_relu; the kernel is csrc/stem.cu (bf16 mma.sync, its weight
laid out as A fragments by ``stem_weight_fragments``; the outputs whose bf16
value the tensor cores' f32 sums could change recomputed exactly, so that
the kernel equals the plain version bit for bit). Any batch and any Ho,
Wo."""

from __future__ import annotations

import ctypes

import torch

from relation_tpu_torch.ops.kernels import _build

launches = 0          # kernel launches of stem_conv1_bn_relu (CUDA only)


def stem_reference(s2d: torch.Tensor, w4: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """Plain version (relation_tpu stem_reference): 16 tap slices of the
    (2,1)-padded s2d input, one [192, 64] matmul on bf16-rounded operands,
    BN scale/bias, ReLU, bf16 out. The sum of the exact bf16 products is
    taken in f64 (exact at these widths) and rounded once to f32: the
    correctly rounded value of JAX's f32 accumulation, which any f32 order
    only approximates. s2d [B, 12, Ho, Wo] f32 -> [B, 64, Ho, Wo] bf16."""
    B, K, Ho, Wo = s2d.shape
    sp = torch.nn.functional.pad(s2d.to(torch.bfloat16).double(), (2, 1, 2, 1))
    taps = torch.cat([sp[:, :, dh:dh + Ho, dw:dw + Wo]
                      for dh in range(4) for dw in range(4)], dim=1)
    w = w4.to(torch.bfloat16).double()                          # [16K, 64]
    acc = torch.einsum("ko,bkn->bon", w,
                       taps.reshape(B, 16 * K, Ho * Wo)).float()
    y = torch.relu(acc * scale[None, :, None] + bias[None, :, None])
    return y.to(torch.bfloat16).reshape(B, 64, Ho, Wo)


def stem_weight_fragments(w4: torch.Tensor) -> torch.Tensor:
    """The [192, 64] weight (rows (dh*4 + dw)*12 + k) as the kernel's A
    fragments: [4, 16, 32, 8] bf16, indexed [m-tile, tap, lane, e]. The GEMM
    depth is one k16 step a tap, its 12 channels padded with zeros to 16
    (k = tap*16 + channel); m-tile mt holds channels 16 mt .. 16 mt + 15.
    Lane l (gid = l // 4, tig = l % 4) holds, as mma.sync m16n8k16 reads
    them, register r = e // 2, half e % 2: row gid + 8 (r % 2), column
    2 tig + 8 (r // 2) + e % 2 of the [16 x 16] tile."""
    wp = torch.zeros((16, 16, 64), dtype=torch.bfloat16, device=w4.device)
    wp[:, :12] = w4.to(torch.bfloat16).reshape(16, 12, 64)      # [tap, ch, o]
    lane = torch.arange(32, device=w4.device)[:, None]
    e = torch.arange(8, device=w4.device)[None, :]
    r = e // 2
    row = lane // 4 + 8 * (r % 2)                               # [32, 8]
    col = 2 * (lane % 4) + 8 * (r // 2) + e % 2
    o = 16 * torch.arange(4, device=w4.device)[:, None, None] + row   # [4, 32, 8]
    # [tap, m-tile, lane, e] -> [m-tile, tap, lane, e]
    return wp[:, col[None].expand(4, 32, 8), o].permute(1, 0, 2, 3).contiguous()


def _check(s2d, w4, scale, bias):
    if s2d.shape[1] != 12 or w4.shape != (192, 64) or scale.shape != (64,) \
            or bias.shape != (64,):
        raise ValueError(f"stem: shapes {tuple(s2d.shape)}, {tuple(w4.shape)}, "
                         f"{tuple(scale.shape)}, {tuple(bias.shape)}")
    if s2d.dtype != torch.float32 or scale.dtype != torch.float32 \
            or bias.dtype != torch.float32:
        raise TypeError("stem: expects a float32 image and BN vectors")


def _launch(s2d, wf, scale, bias):
    """The kernel on checked CUDA tensors, with the weight already laid out
    by ``stem_weight_fragments``."""
    B, _, Ho, Wo = s2d.shape
    if s2d.data_ptr() % 16:            # read in 16-byte pieces
        s2d = s2d.clone()
    _build.check_inputs("stem", s2d, wf, scale, bias)
    out = torch.empty((B, 64, Ho, Wo), dtype=torch.bfloat16, device=s2d.device)
    fn = _build.load("stem").stem_conv1_bn_relu
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    rc = fn(_build.ptr(s2d), _build.ptr(wf), _build.ptr(scale),
            _build.ptr(bias), _build.ptr(out), B, Ho, Wo,
            _build.stream_ptr(s2d.device))
    _build.check(rc, "stem_conv1_bn_relu")
    return out


class _Stem(torch.autograd.Function):
    """forward = the kernel; backward = autograd of the plain version on the
    saved inputs (the rule of relation_tpu/ops/pallas/stem.py:81-95)."""

    @staticmethod
    def forward(ctx, s2d, w4, scale, bias):
        _check(s2d, w4, scale, bias)
        out = _launch(s2d.contiguous(), stem_weight_fragments(w4),
                      scale.contiguous(), bias.contiguous())
        _build.count(globals(), "launches")
        ctx.save_for_backward(s2d, w4, scale, bias)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        need = ctx.needs_input_grad
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            out = stem_reference(*ins)
            wanted = [t for t, n in zip(ins, need) if n]
            grads = iter(torch.autograd.grad(out, wanted, gout))
        return tuple(next(grads) if n else None for n in need)


def stem_conv1_bn_relu(s2d: torch.Tensor, w4: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """relu(bn(conv1)) from the s2d planar image: s2d [B, 12, Ho, Wo] f32,
    w4 [192, 64] (models/backbone.py::conv1_w4), folded BN scale/bias [64]
    -> [B, 64, Ho, Wo] bf16. CUDA tensors launch the kernel (equal to the
    plain version bit for bit), and a gradient through it is autograd of the
    plain version; CPU tensors take the plain version."""
    if s2d.device.type != "cuda":
        return stem_reference(s2d, w4, scale, bias)
    return _Stem.apply(s2d, w4, scale, bias)
