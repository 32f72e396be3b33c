"""Fused geometric attention bias (forward): CUDA kernel and plain version.

    bias[c, g, n, m] = log(max(sincos_emb(100 * pos[c, :, n, m]) @ W + b, 1e-6))

with the reference's sinusoid embedding (4 fields x 8 frequencies x {sin, cos},
feature layout j*16 + (sin 0-7 | cos 8-15)) and W/b the pair_pos_fc1 dense.
Port of relation_tpu/ops/pallas/geom_bias.py::fused_geometric_bias; the kernel
is csrc/geom_bias.cu.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from relation_tpu_torch.ops.kernels import _build

launches = 0          # kernel launches of fused_geometric_bias (CUDA only)
_SUPPORTED_G = (4, 8, 16, 32)


def _frequencies(wave_length: float = 1000.0) -> np.ndarray:
    """1/lambda_k for k=0..7 (reference dim_mat, feat_dim=64, 4 fields)."""
    k = np.arange(8, dtype=np.float64)
    return (1.0 / np.power(wave_length, (8.0 / 64.0) * k)).astype(np.float32)


def geom_bias_reference(pos_t: torch.Tensor, kernel: torch.Tensor,
                        bias: torch.Tensor, scale: float = 100.0) -> torch.Tensor:
    """Plain version: [C, 4, N, M], W [64, G], b [G] -> [C, G, N, M]
    (relation_tpu geom_bias_reference with f32 embedding)."""
    freqs = torch.as_tensor(_frequencies(), device=pos_t.device)
    div = pos_t[:, :, None, :, :] * scale * freqs[None, None, :, None, None]
    emb = torch.cat([torch.sin(div), torch.cos(div)], dim=2)   # [C, 4, 16, N, M]
    C, _, _, N, M = emb.shape
    acc = torch.einsum("cfnm,fg->cgnm", emb.reshape(C, 64, N, M), kernel)
    return torch.log(torch.clamp_min(acc + bias[None, :, None, None], 1e-6))


def _launch(pos_t, kernel, bias, scale):
    C, four, N, M = pos_t.shape
    G = kernel.shape[1]
    if four != 4 or kernel.shape[0] != 64 or bias.shape != (G,):
        raise ValueError(f"geom_bias: shapes {tuple(pos_t.shape)}, "
                         f"{tuple(kernel.shape)}, {tuple(bias.shape)}")
    if G not in _SUPPORTED_G:
        raise ValueError(f"geom_bias: G={G} not in {_SUPPORTED_G}")
    for t in (pos_t, kernel, bias):
        if t.dtype != torch.float32:
            raise TypeError(f"geom_bias: expects float32, got {t.dtype}")
    _build.check_inputs("geom_bias", pos_t, kernel, bias)
    out = torch.empty((C, G, N, M), dtype=torch.float32, device=pos_t.device)
    lib = _build.load("geom_bias")
    fn = lib.geom_bias_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_long, ctypes.c_float,
                                           ctypes.c_void_p]
    rc = fn(_build.ptr(pos_t), _build.ptr(kernel), _build.ptr(bias),
            _build.ptr(out), C, G, N * M, float(scale),
            _build.stream_ptr(pos_t.device))
    _build.check(rc, "geom_bias_fwd")
    return out


def fused_geometric_bias(pos_t: torch.Tensor, kernel: torch.Tensor,
                         bias: torch.Tensor, scale: float = 100.0) -> torch.Tensor:
    """[C, 4, N, M] geometry, W [64, G], b [G] -> [C, G, N, M] f32 bias.
    CUDA tensors launch the kernel; CPU tensors take the plain version.
    Inference only: no gradient (the backward kernel is not ported yet)."""
    global launches
    if pos_t.device.type != "cuda":
        return geom_bias_reference(pos_t, kernel, bias, scale)
    out = _launch(pos_t.contiguous(), kernel.contiguous(), bias.contiguous(),
                  scale)
    launches += 1
    return out
