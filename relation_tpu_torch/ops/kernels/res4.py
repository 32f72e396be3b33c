"""A stack of identity bottleneck blocks with BatchNorm folded into the
weights (res4b1..res4b22 of ResNet-101, and the identity units of res2 and
res3): CUDA kernel and plain version. Port of
relation_tpu/ops/pallas/res4.py::fused_bottleneck_stack; the kernel is
csrc/bottleneck.cu (``bottleneck_stack``).

Per block, on the map x [H, W, C] as H*W rows:

    y1 = relu(x @ Wa + b1)                     1x1 reduce
    y2 = relu(sum_t shift_t(y1) @ W3[t] + b2)  3x3 as 9 shifted products
    x  = relu(x + y2 @ Wc + b3)                1x1 expand + residual

with f32 products of bf16 operands, and y1, y2 and the block output cast
back to x.dtype. One call is one memset of the kernel's tile counters and
one launch of the persistent wgmma/TMA kernel, whatever B; the caller's
tensor is never written.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from relation_tpu_torch.ops.kernels import _build

launches = 0          # calls of fused_bottleneck_stack that ran the kernel


def bottleneck_stack_reference(x, wa, b1, w3, b2, wc, b3):
    """Plain version (relation_tpu/ops/pallas/res4.py::
    bottleneck_stack_reference, step for step): x [H, W, C]; wa [B, C, Cmid];
    b1 [B, Cmid]; w3 [B, 9*Cmid, Cmid] with tap-major rows (tap t = dy*3 +
    dx); b2 [B, Cmid]; wc [B, Cmid, C]; b3 [B, C]. -> [H, W, C] in x.dtype."""
    H, W, C = x.shape
    B, _, Cmid = wa.shape
    dt = x.dtype
    f32 = torch.float32
    for i in range(B):
        y1 = torch.relu(x.reshape(-1, C).to(f32) @ wa[i].to(f32)
                        + b1[i].to(f32)).to(dt).reshape(H, W, Cmid)
        y1pad = F.pad(y1, (0, 0, 1, 1, 1, 1))
        acc = torch.zeros((H * W, Cmid), dtype=f32, device=x.device)
        for t in range(9):
            dy, dx = t // 3, t % 3
            patch = y1pad[dy:dy + H, dx:dx + W, :].reshape(-1, Cmid)
            acc = acc + patch.to(f32) @ w3[i, t * Cmid:(t + 1) * Cmid].to(f32)
        y2 = torch.relu(acc + b2[i].to(f32)).to(dt)
        y3 = y2.to(f32) @ wc[i].to(f32) + b3[i].to(f32)
        x = torch.relu(x.reshape(-1, C).to(f32) + y3).to(dt).reshape(H, W, C)
    return x


def _launch(x, wa, b1, w3, b2, wc, b3):
    if x.dim() != 3 or wa.dim() != 3:
        raise ValueError(f"fused_bottleneck_stack: x {tuple(x.shape)}, "
                         f"wa {tuple(wa.shape)}")
    H, W, C = x.shape
    B, _, Cmid = wa.shape
    want = {"wa": (B, C, Cmid), "b1": (B, Cmid), "w3": (B, 9 * Cmid, Cmid),
            "b2": (B, Cmid), "wc": (B, Cmid, C), "b3": (B, C)}
    got = dict(wa=wa, b1=b1, w3=w3, b2=b2, wc=wc, b3=b3)
    bad = {k: tuple(got[k].shape) for k, s in want.items()
           if tuple(got[k].shape) != s}
    if bad or C % 64 or Cmid % 64:
        raise ValueError(f"fused_bottleneck_stack: x {tuple(x.shape)}, "
                         f"mismatched {bad}; the kernel needs C and Cmid "
                         "multiples of 64")
    if any(t.dtype != torch.bfloat16 for t in (x, wa, w3, wc)) or any(
            t.dtype != torch.float32 for t in (b1, b2, b3)):
        raise TypeError("fused_bottleneck_stack: the CUDA kernel takes a bf16 "
                        "map and bf16 weights with f32 biases")
    ins = [t.contiguous() for t in (x, wa, b1, w3, b2, wc, b3)]
    _build.check_inputs("fused_bottleneck_stack", *ins)
    out = torch.empty_like(ins[0])
    y1 = torch.empty((H * W, Cmid), dtype=torch.bfloat16, device=x.device)
    y2 = torch.empty_like(y1)
    if any(t.data_ptr() % 16 for t in ins + [out]):
        raise ValueError("fused_bottleneck_stack: tensors must be 16-byte aligned")
    fn = _build.load("bottleneck").bottleneck_stack
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    rc = fn(*[_build.ptr(t) for t in ins + [out, y1, y2]], B, H, W, C, Cmid,
            _build.stream_ptr(x.device))
    _build.check(rc, "bottleneck_stack")
    return out


class _Stack(torch.autograd.Function):
    """forward = the kernel; backward = autograd of the plain version on the
    saved inputs (the rule of relation_tpu/ops/pallas/res4.py:140-147: a
    training step recomputes the stack, inference never takes that path)."""

    @staticmethod
    def forward(ctx, x, wa, b1, w3, b2, wc, b3):
        out = _launch(x, wa, b1, w3, b2, wc, b3)
        _build.count(globals(), "launches")
        ctx.save_for_backward(x, wa, b1, w3, b2, wc, b3)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        need = ctx.needs_input_grad
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            out = bottleneck_stack_reference(*ins)
            wanted = [t for t, n in zip(ins, need) if n]
            grads = iter(torch.autograd.grad(out, wanted, gout))
        return tuple(next(grads) if n else None for n in need)


def fused_bottleneck_stack(x, wa, b1, w3, b2, wc, b3) -> torch.Tensor:
    """Run B identity bottlenecks over x [H, W, C] (layouts of
    ``bottleneck_stack_reference``; BN already folded into the weights).
    CUDA tensors launch the kernel (bf16 map and weights, f32 biases, C and
    Cmid multiples of 64), and a gradient through it is autograd of the
    plain version; CPU tensors take the plain version."""
    if x.device.type != "cuda":
        return bottleneck_stack_reference(x, wa, b1, w3, b2, wc, b3)
    return _Stack.apply(x, wa, b1, w3, b2, wc, b3)
