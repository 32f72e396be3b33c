"""Box geometry primitives, with the legacy ``+1`` width/height convention.

Port of relation_tpu/ops/boxes.py (reference lib/bbox/bbox_transform.py:45-186,
lib/bbox/bbox.pyx:15-55). Plain tensor code on any device.
"""

from __future__ import annotations

import torch


def box_wh(boxes: torch.Tensor):
    """Width/height under the legacy +1 convention. boxes: [..., 4] (x1,y1,x2,y2)."""
    return boxes[..., 2] - boxes[..., 0] + 1.0, boxes[..., 3] - boxes[..., 1] + 1.0


def box_ctr(boxes: torch.Tensor):
    """Box centers under the legacy convention (x1 + 0.5*(w-1))."""
    w, h = box_wh(boxes)
    return boxes[..., 0] + 0.5 * (w - 1.0), boxes[..., 1] + 0.5 * (h - 1.0)


def bbox_transform(ex_rois: torch.Tensor, gt_rois: torch.Tensor) -> torch.Tensor:
    """Regression targets from ex_rois to gt_rois (reference
    nonlinear_transform): [..., 4], [..., 4] -> (dx, dy, dw, dh) [..., 4]."""
    ex_w, ex_h = box_wh(ex_rois)
    ex_cx, ex_cy = box_ctr(ex_rois)
    gt_w, gt_h = box_wh(gt_rois)
    gt_cx, gt_cy = box_ctr(gt_rois)
    dx = (gt_cx - ex_cx) / (ex_w + 1e-14)
    dy = (gt_cy - ex_cy) / (ex_h + 1e-14)
    return torch.stack([dx, dy, torch.log(gt_w / ex_w), torch.log(gt_h / ex_h)],
                       dim=-1)


def bbox_pred(boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Decode deltas on top of boxes (reference nonlinear_pred).
    boxes: [..., N, 4]; deltas: [..., N, 4*K] -> [..., N, 4*K]."""
    w, h = box_wh(boxes)
    cx, cy = box_ctr(boxes)
    d = deltas.reshape(deltas.shape[:-1] + (-1, 4))
    dx, dy, dw, dh = d.unbind(-1)
    pcx = dx * w[..., None] + cx[..., None]
    pcy = dy * h[..., None] + cy[..., None]
    pw = torch.exp(dw) * w[..., None]
    ph = torch.exp(dh) * h[..., None]
    out = torch.stack([pcx - 0.5 * (pw - 1.0), pcy - 0.5 * (ph - 1.0),
                       pcx + 0.5 * (pw - 1.0), pcy + 0.5 * (ph - 1.0)], dim=-1)
    return out.reshape(deltas.shape)


def clip_boxes(boxes: torch.Tensor, im_hw) -> torch.Tensor:
    """Clip boxes (layout [..., 4*K]) to [0, im-1]. im_hw: (height, width)."""
    h, w = (torch.as_tensor(v, dtype=boxes.dtype, device=boxes.device)
            for v in (im_hw[0], im_hw[1]))
    b = boxes.reshape(boxes.shape[:-1] + (-1, 4))
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(b[..., 0], zero), w - 1)
    y1 = torch.minimum(torch.maximum(b[..., 1], zero), h - 1)
    x2 = torch.minimum(torch.maximum(b[..., 2], zero), w - 1)
    y2 = torch.minimum(torch.maximum(b[..., 3], zero), h - 1)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(boxes.shape)


def bbox_overlaps(boxes: torch.Tensor, query_boxes: torch.Tensor) -> torch.Tensor:
    """N x K IoU matrix with the +1 area convention. [N, 4], [K, 4] -> [N, K]."""
    bw, bh = box_wh(boxes)
    qw, qh = box_wh(query_boxes)
    ix1 = torch.maximum(boxes[:, None, 0], query_boxes[None, :, 0])
    iy1 = torch.maximum(boxes[:, None, 1], query_boxes[None, :, 1])
    ix2 = torch.minimum(boxes[:, None, 2], query_boxes[None, :, 2])
    iy2 = torch.minimum(boxes[:, None, 3], query_boxes[None, :, 3])
    inter = (ix2 - ix1 + 1.0).clamp_min(0.0) * (iy2 - iy1 + 1.0).clamp_min(0.0)
    union = (bw * bh)[:, None] + (qw * qh)[None, :] - inter
    return torch.where(inter > 0, inter / union, torch.zeros_like(inter))


def refine_bbox(bbox: torch.Tensor, bbox_delta: torch.Tensor, im_hw=None,
                means=None, stds=None) -> torch.Tensor:
    """Decode per-class deltas into refined, optionally clipped boxes
    (reference ...learn_nms_base.py:29-90). bbox: [N, 4];
    bbox_delta: [N, 4*K] -> [N, 4, K]."""
    w, h = box_wh(bbox)
    cx, cy = box_ctr(bbox)
    dx, dy, dw, dh = bbox_delta.reshape(bbox.shape[0], -1, 4).unbind(-1)
    if means is not None and stds is not None:
        dx = dx * stds[0] + means[0]
        dy = dy * stds[1] + means[1]
        dw = dw * stds[2] + means[2]
        dh = dh * stds[3] + means[3]
    rcx = cx[:, None] + w[:, None] * dx
    rcy = cy[:, None] + h[:, None] * dy
    rw = w[:, None] * torch.exp(dw)
    rh = h[:, None] * torch.exp(dh)
    out = torch.stack([rcx - 0.5 * (rw - 1.0), rcy - 0.5 * (rh - 1.0),
                       rcx + 0.5 * (rw - 1.0), rcy + 0.5 * (rh - 1.0)], dim=1)
    if im_hw is not None:
        h, w = (torch.as_tensor(v, dtype=out.dtype, device=out.device)
                for v in (im_hw[0], im_hw[1]))
        lim = torch.stack([w - 1.0, h - 1.0, w - 1.0, h - 1.0])
        out = torch.minimum(out, lim[None, :, None]).clamp_min(0.0)
    return out
