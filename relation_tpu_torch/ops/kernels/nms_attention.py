"""Learned-NMS relation attention, fully fused, with and without class
skipping: CUDA kernel and plain version. Port of
relation_tpu/ops/pallas/nms_attention.py::fused_nms_relation_attention_skip
(inference) and ::fused_nms_relation_attention (every class, differentiable:
the training form); both run the one kernel body of csrc/nms_attention.cu,
whose value projection and attention body (csrc/attention_tc.cuh) it shares
with the bias attention of ops/kernels/bias_attention.py.

    bias   = log(max(sincos_emb(100 * pos) @ Wg + bg, 1e-6))     [C, G, N, N]
    attn_g = softmax(q_g k_g^T / sqrt(D) + bias_g)
    out    = concat_g((attn_g @ v) @ Wl[g])                     [C, N, G*E]
"""

from __future__ import annotations

import ctypes

import torch

from relation_tpu_torch.ops.kernels import _build
from relation_tpu_torch.ops.kernels.geom_bias import geom_bias_reference
from relation_tpu_torch.utils import trace

launches = 0          # kernel launches of the skip attention (CUDA only)
full_launches = 0     # kernel launches of the unskipped attention (CUDA only)
launch_shapes: dict[str, int] = {}  # skip-attention launches by "C= N="
MAX_SMEM = 232_448    # shared memory a Hopper block may use, bytes
_NT_BUCKETS = (2, 4, 8, 13, 19)   # n8 tiles of a key chunk, by instantiation
_CHUNK_KEYS = 152     # keys a chunk holds above N = 152 (19 n8 tiles)
_MAX_WARPS = 10       # query row tiles of a task (160 rows)


def smem_bytes(N: int, D: int, E: int, C: int, F: int = 0) -> int:
    """The larger dynamic shared memory of the two kernels of a learned-NMS
    attention call (csrc/attention_tc.cuh, the layout of rows 6-9): the
    attention's q rows of a task, k rows and two buffers of u rows of a key
    chunk (q and k padded to a multiple of 8 columns), the chunk's bias tile
    and the list of active classes; the value projection's 64 columns of Wl
    seen as an [F, G*E] matrix (F padded to 8, rows 4 floats longer) and its
    64 rows of v."""
    keys = min(N, _CHUNK_KEYS)
    nt = next(b for b in _NT_BUCKETS if 8 * b >= keys)
    rows = 16 * min(-(-N // 16), _MAX_WARPS)
    dp = -(-D // 8) * 8
    ds = dp + (8 - dp % 32) % 32
    us = -(-E // 8) * 8 + 4
    floats = (rows * ds + -(-min(rows, N) * keys // 4) * 4 + 8 * nt * ds
              + 2 * 8 * nt * us + C)
    fp = -(-F // 8) * 8
    proj = fp * 68 + 64 * (fp + (8 - fp % 32) % 32)
    return 4 * max(floats, proj)


def check_attention_shape(name: str, C: int, N: int, D: int, F: int,
                          E: int) -> None:
    """Raise ValueError, before any launch, for a shape the fused attention
    kernel does not take: D or F no multiple of 4, or a layout over the
    shared memory of a block."""
    if D % 4 or F % 4:
        raise ValueError(f"{name}: needs D and F multiples of 4 "
                         f"(got D={D}, F={F})")
    need = smem_bytes(N, D, E, C, F)
    if need > MAX_SMEM:
        raise ValueError(f"{name}: N={N}, D={D}, F={F}, E={E} need {need} "
                         f"bytes of shared memory a block, over the {MAX_SMEM} "
                         "a Hopper block has")


def nms_relation_attention_reference(pos_t, q, k, v, wg, bg, wl, active=None,
                                     scale: float = 100.0):
    """Plain version (relation_tpu nms_relation_attention_reference).
    pos_t [C,4,N,N]; q, k [C,N,G*D]; v [C,N,F]; wg [64,G]; bg [G];
    wl [G,F,E] -> [C, N, G*E] (head-major channels g*E + e). With ``active``
    [C], only active classes are computed; the other rows are zero."""
    if active is not None:
        trace.count("host_read.skip_classes")
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
    # the width spelled out: C may be 0 (no class active)
    return torch.einsum("cgif,gfe->cige", av, wl).reshape(
        C, N, wl.shape[0] * wl.shape[2])


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
    check_attention_shape(name, C, N, D, F, E)
    # q, k and v are read in 16-byte pieces: 16-byte aligned storage
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
    (a persistent grid of clusters of heads over (active class, head group,
    up to 160 query rows), the bias made on the tensor cores into each
    head's tile, keys in chunks of up to 152 joined by an online softmax:
    any N, D and F multiples of 4, about 200 KB of shared memory a block at
    N=150; a shape that does not fit is refused with a ValueError before the
    launch); CPU tensors take the plain version. Inference only: on the card
    an input that requires a gradient is refused, never answered
    detached."""
    if pos_t.device.type != "cuda":
        return nms_relation_attention_reference(pos_t, q, k, v, wg, bg, wl,
                                                active, scale)
    _build.refuse_grad("fused_nms_relation_attention_skip",
                       pos_t, q, k, v, wg, bg, wl)
    out = _launch(pos_t, q, k, v, wg, bg, wl, active, scale,
                  "fused_nms_relation_attention_skip")
    _build.count(globals(), "launches", "launch_shapes",
                 f"C={pos_t.shape[0]} N={pos_t.shape[2]}")
    return out


class _FullAttention(torch.autograd.Function):
    """forward = the kernel over every class; backward = autograd of the
    plain version, run again on the saved inputs (the rule of the JAX
    package's custom VJP)."""

    @staticmethod
    def forward(ctx, pos_t, q, k, v, wg, bg, wl, scale):
        out = _launch(pos_t, q, k, v, wg, bg, wl, None, scale,
                      "fused_nms_relation_attention")
        _build.count(globals(), "full_launches")
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
