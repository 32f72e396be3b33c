"""Learned-NMS relation attention, fully fused, with and without class
skipping: CUDA kernel and plain version. Port of
relation_tpu/ops/pallas/nms_attention.py::fused_nms_relation_attention_skip
(inference) and ::fused_nms_relation_attention (every class, differentiable:
the training form); both run the one kernel body of csrc/nms_attention.cu.

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
full_launches = 0     # kernel launches of the unskipped attention (CUDA only)
launch_shapes: dict[str, int] = {}  # skip-attention launches by "C= N="
MAX_SMEM = 232_448    # shared memory a Hopper block may use, bytes
_WHOLE_N = 128        # up to this N a block takes every query row, above
_ROW_TILE = 64        # at most this many (csrc/attention_rows.cuh)


def smem_bytes(N: int, D: int, E: int, extra_floats: int = 0) -> int:
    """Shared memory of one block of the attention kernels
    (csrc/attention_rows.cuh: q^T of a tile of query rows, k^T, the
    [rows, N] score tile, u_g = v @ Wl_g, the row sums), plus
    ``extra_floats``."""
    def pad4(x):
        return (x + 3) // 4 * 4
    tiles = 1 if N <= _WHOLE_N else -(-N // _ROW_TILE)
    tr, np_ = pad4(-(-N // tiles)), pad4(N)
    return 4 * (D * tr + D * np_ + tr * np_ + E * np_ + tr + extra_floats)


def check_attention_shape(name: str, N: int, D: int, F: int, E: int,
                          extra_floats: int = 0) -> None:
    """Raise ValueError, before any launch, for a shape the attention
    kernels do not take."""
    if D % 4 or F % 4:
        raise ValueError(f"{name}: needs D and F multiples of 4 "
                         f"(got D={D}, F={F})")
    need = smem_bytes(N, D, E, extra_floats)
    if need > MAX_SMEM:
        raise ValueError(f"{name}: N={N} needs {need} bytes of shared memory "
                         f"a block, over the {MAX_SMEM} a Hopper block has")


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


def _launch(pos_t, q, k, v, wg, bg, wl, active, scale, name):
    """The kernel on checked CUDA tensors; ``active`` None computes every
    class."""
    C, four, N, N2 = pos_t.shape
    G = wg.shape[1]
    D = q.shape[2] // G
    F, E = v.shape[2], wl.shape[2]
    if (four != 4 or N2 != N or q.shape != (C, N, G * D) or k.shape != q.shape
            or v.shape != (C, N, F) or wg.shape != (64, G) or bg.shape != (G,)
            or wl.shape != (G, F, E)
            or (active is not None and active.shape != (C,))):
        raise ValueError(f"{name}: inconsistent shapes")
    cs = max(c for c in (8, 4, 2, 1) if G % c == 0)   # heads a cluster
    check_attention_shape(name, N, D, F, E, extra_floats=64 * cs)
    # q, k and v are read as float4s: 16-byte aligned storage
    tensors = [t.contiguous() for t in (pos_t, q, k, v, wg, bg, wl)]
    tensors = [t if t.data_ptr() % 16 == 0 else t.clone() for t in tensors]
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expects float32")
    out = torch.empty((C, N, G * E), dtype=torch.float32, device=pos_t.device)
    u = torch.empty_like(out)               # v @ Wl per head, the workspace
    ptrs = [_build.ptr(t) for t in tensors]
    tail = [C, N, G, D, F, E, float(scale), _build.stream_ptr(pos_t.device)]
    types = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    lib = _build.load("nms_attention")
    if active is None:
        _build.check_inputs(name, *tensors)
        fn = lib.nms_attention_full
        fn.argtypes = [ctypes.c_void_p] * 9 + types
        args = ptrs + [_build.ptr(out), _build.ptr(u)] + tail
    else:
        act = active.to(torch.int32).contiguous()
        _build.check_inputs(name, *tensors, act)
        fn = lib.nms_attention_skip
        fn.argtypes = [ctypes.c_void_p] * 10 + types
        args = ptrs + [_build.ptr(act), _build.ptr(out), _build.ptr(u)] + tail
    fn.restype = ctypes.c_int
    _build.check(fn(*args), name)
    return out


def fused_nms_relation_attention_skip(pos_t, q, k, v, wg, bg, wl, active,
                                      scale: float = 100.0) -> torch.Tensor:
    """Single fused kernel for the active classes (``active`` [C] int32).
    Inactive classes' rows are left unwritten on the card, as on the TPU: the
    learned-NMS head masks them with where(). CUDA tensors launch the kernel
    (one block per class, head and tile of query rows, every row up to
    N=128 and at most 64 above, about 91 KB of shared memory at N=150; a
    shape that does not fit is refused with a ValueError before the
    launch); CPU tensors take the plain version. Inference only: on the card
    an input that requires a gradient is refused, never answered
    detached."""
    global launches
    if pos_t.device.type != "cuda":
        return nms_relation_attention_reference(pos_t, q, k, v, wg, bg, wl,
                                                active, scale)
    _build.refuse_grad("fused_nms_relation_attention_skip",
                       pos_t, q, k, v, wg, bg, wl)
    out = _launch(pos_t, q, k, v, wg, bg, wl, active, scale,
                  "fused_nms_relation_attention_skip")
    launches += 1
    _build.tally(launch_shapes, f"C={pos_t.shape[0]} N={pos_t.shape[2]}")
    return out


class _FullAttention(torch.autograd.Function):
    """forward = the kernel over every class; backward = autograd of the
    plain version, run again on the saved inputs (the rule of the JAX
    package's custom VJP)."""

    @staticmethod
    def forward(ctx, pos_t, q, k, v, wg, bg, wl, scale):
        global full_launches
        out = _launch(pos_t, q, k, v, wg, bg, wl, None, scale,
                      "fused_nms_relation_attention")
        full_launches += 1
        ctx.save_for_backward(pos_t, q, k, v, wg, bg, wl)
        ctx.scale = scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        need = ctx.needs_input_grad[:7]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            out = nms_relation_attention_reference(*ins, None, ctx.scale)
            wanted = [t for t, n in zip(ins, need) if n]
            grads = iter(torch.autograd.grad(out, wanted, gout))
        return tuple(next(grads) if n else None for n in need) + (None,)


def fused_nms_relation_attention(pos_t, q, k, v, wg, bg, wl,
                                 scale: float = 100.0) -> torch.Tensor:
    """The fused kernel over every class, differentiable: the training form
    (NMSRelationModule(fully_fused=True)). Shapes as the plain version;
    returns [C, N, G*E], head-major. CUDA tensors launch the kernel and take
    their gradient from autograd of the plain version; CPU tensors take the
    plain version."""
    if pos_t.device.type != "cuda":
        return nms_relation_attention_reference(pos_t, q, k, v, wg, bg, wl,
                                                None, scale)
    return _FullAttention.apply(pos_t, q, k, v, wg, bg, wl, float(scale))
