"""ROI feature extraction (port of relation_tpu/ops/roi_pool.py): ROIAlign
as two interpolation contractions (``roi_align_mxu``, the JAX package's
head, kept as the reference of the parity tests), ROIAlign in its gather
form (``roi_align``, the plain version of the heads' pyramid ROIAlign,
ops/kernels/roi_align.py) and exact MXNet ROIPooling
(``roi_pool``, TPU.ROI_METHOD='pool', the parity mode of converted reference
weights; its kernel and plain version are in ops/kernels/roi_pool.py).

For roi_align_mxu, bilinear sampling plus bin averaging is linear in the
feature map and separable per axis: out[r, p, q, c] = By[r, p, :] @
feat[:, :, c] @ Bx[r, :, q]. The ROIs are detached in every form: the head
sends no gradient to its ROIs, by the same contract as the JAX op's custom
VJP (relation_tpu/ops/roi_pool.py:146-156) and the reference's ROIPooling.
"""

from __future__ import annotations

import torch

from relation_tpu_torch.ops.kernels.roi_pool import roi_pool  # noqa: F401


def _bilinear_gather(feat: torch.Tensor, y: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of feat [H, W, C] at float coordinates y, x [...]
    (clamped into the map) -> [..., C]."""
    H, W, C = feat.shape
    y = y.clamp(0.0, H - 1.0)
    x = x.clamp(0.0, W - 1.0)
    y0, x0 = torch.floor(y), torch.floor(x)
    y1, x1 = torch.clamp_max(y0 + 1, H - 1.0), torch.clamp_max(x0 + 1, W - 1.0)
    ly, lx = (y - y0)[..., None], (x - x0)[..., None]
    flat = feat.reshape(H * W, C)

    def take(yy, xx):
        idx = (yy.long() * W + xx.long()).reshape(-1)
        return flat[idx].reshape(*y.shape, C)
    return (take(y0, x0) * ((1 - ly) * (1 - lx)) + take(y0, x1) * ((1 - ly) * lx)
            + take(y1, x0) * (ly * (1 - lx)) + take(y1, x1) * (ly * lx))


def roi_align(feat: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
              pooled_size: int = 7, sampling_ratio: int = 2,
              mode: str = "avg") -> torch.Tensor:
    """ROIAlign by sampling: feat [H, W, C]; rois [R, 4] image coordinates
    -> [R, P, P, C], the average (``mode='avg'``) or maximum ('max') of each
    bin's S x S bilinear samples."""
    if mode not in ("avg", "max"):
        raise ValueError(mode)
    R = rois.shape[0]
    P, S = pooled_size, sampling_ratio
    r = rois.detach().to(torch.float32) * spatial_scale
    roi_w = torch.clamp_min(r[:, 2] - r[:, 0], 1.0)
    roi_h = torch.clamp_min(r[:, 3] - r[:, 1], 1.0)
    grid = (torch.arange(P * S, dtype=torch.float32, device=feat.device)
            + 0.5) / S
    ys = r[:, 1, None] + (roi_h / P)[:, None] * grid[None, :]   # [R, P*S]
    xs = r[:, 0, None] + (roi_w / P)[:, None] * grid[None, :]
    samples = _bilinear_gather(
        feat, ys[:, :, None].expand(R, P * S, P * S),
        xs[:, None, :].expand(R, P * S, P * S)).reshape(R, P, S, P, S, -1)
    if mode == "avg":
        return samples.mean(dim=(2, 4))
    return samples.amax(dim=(2, 4))


def roi_align_mxu(feat: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
                  pooled_size: int = 7, sampling_ratio: int = 2) -> torch.Tensor:
    """feat [H, W, C]; rois [R, 4] image coords -> [R, P, P, C] in feat.dtype."""
    H, W, C = feat.shape
    R = rois.shape[0]
    P, S = pooled_size, sampling_ratio
    r = rois.detach().to(torch.float32) * spatial_scale
    roi_w = torch.clamp_min(r[:, 2] - r[:, 0], 1.0)
    roi_h = torch.clamp_min(r[:, 3] - r[:, 1], 1.0)
    grid = (torch.arange(P * S, dtype=torch.float32, device=feat.device)
            + 0.5) / S
    ys = (r[:, 1, None] + (roi_h / P)[:, None] * grid[None, :]).clamp(0.0, H - 1.0)
    xs = (r[:, 0, None] + (roi_w / P)[:, None] * grid[None, :]).clamp(0.0, W - 1.0)

    def interp_matrix(coords, dim):
        g = torch.arange(dim, dtype=torch.float32, device=feat.device)
        w = torch.clamp_min(1.0 - torch.abs(coords[..., None] - g), 0.0)
        return w.reshape(R, P, S, dim).mean(dim=2)              # [R, P, dim]

    dt = torch.bfloat16 if feat.dtype == torch.bfloat16 else torch.float32
    By = interp_matrix(ys, H).to(dt)
    Bx = interp_matrix(xs, W).to(dt)
    f = feat.to(dt)
    # contract the larger spatial axis first (smaller per-ROI intermediate)
    if W >= H:
        a = torch.einsum("rqw,hwc->rqhc", Bx, f)
        out = torch.einsum("rph,rqhc->rpqc", By, a)
    else:
        a = torch.einsum("rph,hwc->rpwc", By, f)
        out = torch.einsum("rpwc,rqw->rpqc", a, Bx)
    return out.to(feat.dtype)
