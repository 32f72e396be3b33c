"""Anchor generation (port of relation_tpu/ops/anchors.py; reference
lib/rpn/generate_anchor.py:22-86). Ratio-major, scale-minor order."""

from __future__ import annotations

import numpy as np
import torch


def generate_anchors(base_size: int = 16, ratios=(0.5, 1, 2),
                     scales=(8, 16, 32)) -> np.ndarray:
    """[A, 4] base anchors; A = len(ratios) * len(scales)."""
    ratios = np.asarray(ratios, dtype=np.float64)
    scales = np.asarray(scales, dtype=np.float64)
    base = np.array([1, 1, base_size, base_size], dtype=np.float64) - 1
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    x_ctr = base[0] + 0.5 * (w - 1)
    y_ctr = base[1] + 0.5 * (h - 1)
    ws_r = np.round(np.sqrt(w * h / ratios))
    hs_r = np.round(ws_r * ratios)
    anchors = []
    for wr, hr in zip(ws_r, hs_r):
        ws = wr * scales
        hs = hr * scales
        anchors.append(np.stack([x_ctr - 0.5 * (ws - 1), y_ctr - 0.5 * (hs - 1),
                                 x_ctr + 0.5 * (ws - 1), y_ctr + 0.5 * (hs - 1)],
                                axis=1))
    return np.concatenate(anchors, axis=0)


def shift_anchors(base_anchors, feat_height: int, feat_width: int,
                  feat_stride: int, device=None) -> torch.Tensor:
    """Full anchor grid [H*W*A, 4] f32, ordered (h, w, a) slowest to fastest:
    the order of the RPN head's [h, w, A, .] outputs."""
    base = torch.as_tensor(np.asarray(base_anchors), dtype=torch.float32,
                           device=device)                       # [A, 4]
    sx = torch.arange(feat_width, dtype=torch.float32,
                      device=base.device) * feat_stride
    sy = torch.arange(feat_height, dtype=torch.float32,
                      device=base.device) * feat_stride
    sy, sx = torch.meshgrid(sy, sx, indexing="ij")              # [H, W]
    shifts = torch.stack([sx, sy, sx, sy], dim=-1)              # [H, W, 4]
    return (shifts[:, :, None, :] + base[None, None]).reshape(-1, 4)
