"""ROIAlign (avg) as two interpolation contractions (port of
relation_tpu/ops/roi_pool.py::roi_align_mxu).

Bilinear sampling plus bin averaging is linear in the feature map and
separable per axis: out[r, p, q, c] = By[r, p, :] @ feat[:, :, c] @ Bx[r, :, q].
The ROIs are detached: the head sends no gradient to its ROIs, by the same
contract as the JAX op's custom VJP (relation_tpu/ops/roi_pool.py:146-156).
"""

from __future__ import annotations

import torch


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
