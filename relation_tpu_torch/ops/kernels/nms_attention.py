"""Learned-NMS relation attention with class skipping, fully fused: CUDA
kernel and plain version. Port of relation_tpu/ops/pallas/nms_attention.py::
fused_nms_relation_attention_skip; the kernel is csrc/nms_attention.cu.

    bias   = log(max(sincos_emb(100 * pos) @ Wg + bg, 1e-6))     [C, G, N, N]
    attn_g = softmax(q_g k_g^T / sqrt(D) + bias_g)
    out    = concat_g((attn_g @ v) @ Wl[g])                     [C, N, G*E]
"""

from __future__ import annotations

import ctypes

import torch

from relation_tpu_torch.ops.kernels import _build
from relation_tpu_torch.ops.kernels.geom_bias import geom_bias_reference

launches = 0          # kernel launches of the skip attention (CUDA only)


def nms_relation_attention_reference(pos_t, q, k, v, wg, bg, wl, active=None,
                                     scale: float = 100.0):
    """Plain version (relation_tpu nms_relation_attention_reference).
    pos_t [C,4,N,N]; q, k [C,N,G*D]; v [C,N,F]; wg [64,G]; bg [G];
    wl [G,F,E] -> [C, N, G*E] (head-major channels g*E + e). With ``active``
    [C], only active classes are computed; the other rows are zero."""
    if active is not None:
        idx = torch.nonzero(active != 0).flatten()
        out = torch.zeros((q.shape[0], q.shape[1], wl.shape[0] * wl.shape[2]),
                          dtype=torch.float32, device=q.device)
        out[idx] = nms_relation_attention_reference(
            pos_t[idx], q[idx], k[idx], v[idx], wg, bg, wl, None, scale)
        return out
    C, N = q.shape[0], q.shape[1]
    G = wg.shape[1]
    d = q.shape[2] // G
    bias = geom_bias_reference(pos_t, wg, bg, scale)            # [C, G, N, N]
    aff = torch.einsum("cigd,cjgd->cgij", q.reshape(C, N, G, d),
                       k.reshape(C, N, G, d)) / (float(d) ** 0.5)
    attn = torch.softmax(aff + bias, dim=-1)
    av = torch.einsum("cgij,cjf->cgif", attn, v)                # [C, G, N, F]
    return torch.einsum("cgif,gfe->cige", av, wl).reshape(C, N, -1)


def fused_nms_relation_attention_skip(pos_t, q, k, v, wg, bg, wl, active,
                                      scale: float = 100.0) -> torch.Tensor:
    """Single fused kernel for the active classes (``active`` [C] int32).
    Inactive classes' rows are left unwritten on the card, as on the TPU: the
    learned-NMS head masks them with where(). CUDA tensors launch the kernel
    (one block of about 150 KB of shared memory per class and head at the
    flagship shape; a shape that does not fit is refused at launch); CPU
    tensors take the plain version."""
    global launches
    if pos_t.device.type != "cuda":
        return nms_relation_attention_reference(pos_t, q, k, v, wg, bg, wl,
                                                active, scale)
    C, four, N, N2 = pos_t.shape
    G = wg.shape[1]
    D = q.shape[2] // G
    F, E = v.shape[2], wl.shape[2]
    if (four != 4 or N2 != N or q.shape != (C, N, G * D) or k.shape != q.shape
            or v.shape != (C, N, F) or wg.shape != (64, G) or bg.shape != (G,)
            or wl.shape != (G, F, E) or active.shape != (C,)):
        raise ValueError("fused_nms_relation_attention_skip: inconsistent shapes")
    if D % 4 or F % 4 or F > 2 * D or E > 16:
        raise ValueError(f"fused_nms_relation_attention_skip: needs D and F "
                         f"multiples of 4, F <= 2 * D and E <= 16 (got D={D}, "
                         f"F={F}, E={E})")
    # q, k and v are read as float4s: 16-byte aligned storage
    tensors = [t.contiguous() for t in (pos_t, q, k, v, wg, bg, wl)]
    tensors = [t if t.data_ptr() % 16 == 0 else t.clone() for t in tensors]
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError("fused_nms_relation_attention_skip: expects float32")
    act = active.to(torch.int32).contiguous()
    _build.check_inputs("fused_nms_relation_attention_skip", *tensors, act)
    out = torch.empty((C, N, G * E), dtype=torch.float32, device=pos_t.device)
    fn = _build.load("nms_attention").nms_attention_skip
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    rc = fn(*(_build.ptr(t) for t in tensors), _build.ptr(act),
            _build.ptr(out), C, N, G, D, F, E, float(scale),
            _build.stream_ptr(pos_t.device))
    _build.check(rc, "nms_attention_skip")
    launches += 1
    return out
