"""Deformable col2im, the image gradient of the deformable-conv backward:
CUDA kernel and plain version. Port of
relation_tpu/ops/pallas/dconv_col2im.py::dconv_col2im; the kernel is
csrc/dconv_col2im.cu.

Both versions compute what the TPU kernel computes,

    dx[b, p, g, c] = sum_s hat(y_s - h(p)) * hat(x_s - w(p)) * inside_s * D[s, c]

with hat(t) = max(1 - |t|, 0), but from the sample coordinates themselves and
not from materialised hat rows: a hat row has at most two non-zeros, so each
sample adds ``w_corner * D[s, :]`` into at most four pixels (the TPU kernel
multiplies dense [256, H*W] tiles because it cannot scatter). There is no
padding of the sample count and no separate transpose: ``d`` arrives in the
order the dcol matrix product writes it and ``dx`` leaves as NHWC.

The kernel turns the scatter into a gather: the samples are binned by the
cell of their top-left corner (an integer atomic gives a slot in the cell's
bucket of CELL_CAP, or one in a spill list), then one warp a pixel sums the
buckets of its four cells and stores each element of ``dx`` once (no
memset), and a last pass adds the spilled samples of crowded cells with f32
atomics; tests/test_torch_col2im.py sums in the kernel's order on the CPU.
The samples of a cell come in the order the atomics rank them, so the last
bits of ``dx`` may change from run to run; the plain version (index_add_)
is deterministic on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from relation_tpu_torch.ops.kernels import _build

launches = 0          # kernel launches of dconv_col2im (CUDA only)
CELL_CAP = 32         # samples a cell's bucket holds (csrc/dconv_col2im.cu::kCap)


def corner_weights(yz: torch.Tensor, xz: torch.Tensor, inside: torch.Tensor,
                   H: int, W: int):
    """The four corners of every sample: (pix [4, ...] long, w [4, ...] f32),
    pix = y * W + x clamped into the map, w the bilinear weight, zero for a
    corner outside [0, H-1] x [0, W-1] and for a sample that is not inside.
    Equal to the hat-row weights max(1 - |y - p|, 0) of the two integer
    neighbours, zero-extension bands included."""
    y0, x0 = torch.floor(yz), torch.floor(xz)
    ly, lx = yz - y0, xz - x0
    m = inside.to(torch.float32)
    pix, wts = [], []
    for dy, wy in ((0, 1 - ly), (1, ly)):
        for dx_, wx in ((0, 1 - lx), (1, lx)):
            yc, xc = y0 + dy, x0 + dx_
            ok = (yc >= 0) & (yc <= H - 1) & (xc >= 0) & (xc <= W - 1)
            pix.append(yc.clamp(0, H - 1).long() * W + xc.clamp(0, W - 1).long())
            wts.append(wy * wx * ok * m)
    return torch.stack(pix), torch.stack(wts)


def dconv_col2im_reference(yz: torch.Tensor, xz: torch.Tensor,
                           inside: torch.Tensor, d: torch.Tensor,
                           H: int, W: int) -> torch.Tensor:
    """Plain version: four index_add_ passes, f32 accumulation.
    yz, xz, inside [B, S, G]; d [B, S, G, cg] -> dx [B, H, W, G * cg] f32."""
    B, S, G, cg = d.shape
    pix, wts = corner_weights(yz.float(), xz.float(), inside, H, W)
    b_idx = torch.arange(B, device=d.device).view(B, 1, 1)
    g_idx = torch.arange(G, device=d.device).view(1, 1, G)
    out = torch.zeros((B * H * W * G, cg), dtype=torch.float32, device=d.device)
    rows = d.reshape(-1, cg).to(torch.float32)
    for k in range(4):
        r = ((b_idx * (H * W) + pix[k]) * G + g_idx).reshape(-1)
        out.index_add_(0, r, rows * wts[k].reshape(-1, 1))
    return out.view(B, H, W, G * cg)


def _launch(yz, xz, inside, d, H: int, W: int, dx=None) -> torch.Tensor:
    """The kernel's dx, written into ``dx`` [B, H, W, G * cg] f32 where it is
    given (tools/ablate_col2im.py passes one filled with NaN)."""
    B, S, G, cg = d.shape
    nc = (H + 1) * (W + 1)
    f32 = dict(dtype=torch.float32, device=d.device)
    counts = torch.empty(B * G * (nc + 1), dtype=torch.int32, device=d.device)
    bucket = torch.empty((B * G * nc * CELL_CAP, 4), **f32)
    spill = torch.empty((B * G * S, 4), **f32)
    if dx is None:
        dx = torch.empty((B, H, W, G * cg), **f32)
    fn = _build.load("dconv_col2im").dconv_col2im
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 5
    _build.check(fn(_build.ptr(yz), _build.ptr(xz), _build.ptr(inside),
                    _build.ptr(d), int(d.dtype == torch.bfloat16), B, S, G, cg,
                    int(H), int(W), _build.ptr(counts), _build.ptr(bucket),
                    _build.ptr(spill), _build.ptr(dx), _build.stream_ptr(d.device)),
                 "dconv_col2im")
    return dx


def dconv_col2im(yz: torch.Tensor, xz: torch.Tensor, inside: torch.Tensor,
                 d: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Scatter the column gradient back onto the image.

    yz, xz [B, S, G] f32: the sample coordinates of batch b, sample s (any
    order of taps and output positions) and deformable group g, zero where
    the sample is outside; inside [B, S, G] bool: -1 < y < H and -1 < x < W;
    d [B, S, G, cg] f32 or bf16. Returns dx [B, H, W, G * cg] f32.
    CUDA tensors launch the kernel; CPU tensors take the plain version. The
    function has no gradient of its own: it is the backward of the
    deformable conv (ops/deform.py)."""
    if d.device.type != "cuda":
        return dconv_col2im_reference(yz, xz, inside, d, H, W)
    if d.dim() != 4 or yz.shape != d.shape[:3] or xz.shape != yz.shape \
            or inside.shape != yz.shape:
        raise ValueError(f"dconv_col2im: shapes {tuple(yz.shape)}, "
                         f"{tuple(xz.shape)}, {tuple(inside.shape)}, "
                         f"{tuple(d.shape)}")
    if yz.dtype != torch.float32 or xz.dtype != torch.float32 \
            or inside.dtype != torch.bool \
            or d.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("dconv_col2im: expects f32 coordinates, a bool mask "
                        "and f32 or bf16 rows")
    _build.check_inputs("dconv_col2im", yz, xz, inside, d)
    _build.refuse_grad("dconv_col2im", yz, xz, d)
    dx = _launch(yz, xz, inside, d, H, W)
    _build.count(globals(), "launches")
    return dx
