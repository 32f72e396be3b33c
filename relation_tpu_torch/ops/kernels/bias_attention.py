"""Learned-NMS attention with a precomputed geometric bias, with and without
class skipping: CUDA kernel and plain version. Port of
relation_tpu/ops/pallas/nms_attention.py::fused_bias_attention (every class,
differentiable) and ::fused_bias_attention_skip (inference); both run the one
kernel body of csrc/bias_attention.cu. They are the second stage of the
two-stage learned-NMS attention, after the geometric bias
(ops/kernels/geom_bias.py):

    attn_g = softmax(q_g k_g^T / sqrt(D) + bias_g)
    out    = concat_g((attn_g @ v) @ Wl[g])                     [C, N, G*E]
"""

from __future__ import annotations

import ctypes

import torch

from relation_tpu_torch.ops.kernels import _build
from relation_tpu_torch.ops.kernels.nms_attention import MAX_SMEM, smem_bytes

launches = 0          # kernel launches over every class (CUDA only)
skip_launches = 0     # kernel launches with class skipping (CUDA only)
launch_shapes: dict[str, int] = {}  # launches over every class, by "C= N="
MAX_D = 64            # q/k columns of the kernel's k8 steps


def check_shape(name: str, C: int, N: int, D: int, F: int, E: int) -> None:
    """Raise ValueError, before any launch, for a shape the kernels do not
    take."""
    if D % 8 or D > MAX_D or F % 4:
        raise ValueError(f"{name}: needs D a multiple of 8 up to {MAX_D} and "
                         f"F a multiple of 4 (got D={D}, F={F})")
    need = smem_bytes(N, D, E, C, F)
    if need > MAX_SMEM:
        raise ValueError(f"{name}: N={N}, F={F}, E={E} need {need} bytes of "
                         f"shared memory a block, over the {MAX_SMEM} a Hopper "
                         "block has")


def bias_attention_reference(bias, q, k, v, wl, active=None):
    """Plain version (relation_tpu bias_attention_reference). bias
    [C,G,N,N]; q, k [C,N,G*D]; v [C,N,F]; wl [G,F,E] -> [C, N, G*E]
    (head-major channels g*E + e). With ``active`` [C], only active classes
    are computed; the other rows are zero."""
    if active is not None:
        idx = torch.nonzero(active != 0).flatten()
        out = torch.zeros((q.shape[0], q.shape[1], wl.shape[0] * wl.shape[2]),
                          dtype=torch.float32, device=q.device)
        out[idx] = bias_attention_reference(bias[idx], q[idx], k[idx], v[idx],
                                            wl)
        return out
    C, N = q.shape[0], q.shape[1]
    G = bias.shape[1]
    d = q.shape[2] // G
    aff = torch.einsum("cigd,cjgd->cgij", q.reshape(C, N, G, d),
                       k.reshape(C, N, G, d)) / (float(d) ** 0.5)
    attn = torch.softmax(aff + bias, dim=-1)
    av = torch.einsum("cgij,cjf->cgif", attn, v)                # [C, G, N, F]
    # the width spelled out: C may be 0 (no class active)
    return torch.einsum("cgif,gfe->cige", av, wl).reshape(
        C, N, wl.shape[0] * wl.shape[2])


def _launch(bias, q, k, v, wl, active, name):
    """The kernel on checked CUDA tensors; ``active`` None computes every
    class."""
    C, G, N, N2 = bias.shape
    D = q.shape[2] // G if G else 0
    F, E = v.shape[2], wl.shape[2]
    if (N2 != N or q.shape != (C, N, G * D) or k.shape != q.shape
            or v.shape != (C, N, F) or wl.shape != (G, F, E)
            or (active is not None and active.shape != (C,))):
        raise ValueError(f"{name}: inconsistent shapes {tuple(bias.shape)}, "
                         f"{tuple(q.shape)}, {tuple(v.shape)}, {tuple(wl.shape)}")
    check_shape(name, C, N, D, F, E)
    # the kernels read their inputs in 16-byte pieces: 16-byte aligned storage
    tensors = [t.contiguous() for t in (bias, q, k, v, wl)]
    tensors = [t if t.data_ptr() % 16 == 0 else t.clone() for t in tensors]
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expects float32, got {t.dtype}")
    out = torch.empty((C, N, G * E), dtype=torch.float32, device=bias.device)
    u = torch.empty_like(out)               # v @ Wl per head, the workspace
    ptrs = [_build.ptr(t) for t in tensors]
    tail = [C, N, G, D, F, E, _build.stream_ptr(bias.device)]
    types = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib = _build.load("bias_attention")
    if active is None:
        _build.check_inputs(name, *tensors)
        fn = lib.bias_attention_full
        fn.argtypes = [ctypes.c_void_p] * 7 + types
        args = ptrs + [_build.ptr(out), _build.ptr(u)] + tail
    else:
        act = active.to(torch.int32).contiguous()
        _build.check_inputs(name, *tensors, act)
        fn = lib.bias_attention_skip
        fn.argtypes = [ctypes.c_void_p] * 8 + types
        args = ptrs + [_build.ptr(act), _build.ptr(out), _build.ptr(u)] + tail
    fn.restype = ctypes.c_int
    _build.check(fn(*args), name)
    return out


class _BiasAttention(torch.autograd.Function):
    """forward = the kernel over every class; backward = autograd of the
    plain version, run again on the saved inputs (the rule of the JAX
    package's custom VJP, nms_attention.py:251-253)."""

    @staticmethod
    def forward(ctx, bias, q, k, v, wl):
        global launches
        out = _launch(bias, q, k, v, wl, None, "fused_bias_attention")
        launches += 1
        _build.tally(launch_shapes, f"C={bias.shape[0]} N={bias.shape[2]}")
        ctx.save_for_backward(bias, q, k, v, wl)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        need = ctx.needs_input_grad
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            out = bias_attention_reference(*ins)
            wanted = [t for t, n in zip(ins, need) if n]
            grads = iter(torch.autograd.grad(out, wanted, gout))
        return tuple(next(grads) if n else None for n in need)


def fused_bias_attention(bias, q, k, v, wl) -> torch.Tensor:
    """Attention with a precomputed additive [C, G, N, N] bias over every
    class, differentiable. Shapes as the plain version; returns [C, N, G*E],
    head-major. CUDA tensors launch the kernel (a persistent grid over
    (class, head, up to 160 query rows), a warp per 16 query rows on the
    tensor cores, keys in chunks of up to 152 joined by an online softmax;
    any N, D a multiple of 8 up to 64 and F a multiple of 4, another shape
    is refused with a ValueError before the launch) and take their gradient
    from autograd of the plain version; CPU tensors take the plain
    version."""
    if bias.device.type != "cuda":
        return bias_attention_reference(bias, q, k, v, wl)
    return _BiasAttention.apply(bias, q, k, v, wl)


def fused_bias_attention_skip(bias, q, k, v, wl, active) -> torch.Tensor:
    """``fused_bias_attention`` for the classes with ``active`` [C] != 0
    only. On the card the other classes' rows are left unwritten, as on the
    TPU (the learned-NMS head masks them with where()); CPU tensors take the
    plain version (zeros there). Inference only: on the card an input that
    requires a gradient is refused, never answered detached."""
    global skip_launches
    if bias.device.type != "cuda":
        return bias_attention_reference(bias, q, k, v, wl, active)
    _build.refuse_grad("fused_bias_attention_skip", bias, q, k, v, wl)
    out = _launch(bias, q, k, v, wl, active, "fused_bias_attention_skip")
    skip_launches += 1
    return out
