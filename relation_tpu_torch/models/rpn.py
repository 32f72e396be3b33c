"""RPN head and on-device proposal generation (port of
relation_tpu/models/rpn.py; reference symbols/resnet_v1_101_rcnn_base.py:685-693
and operator_py/proposal.py:51-168)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from relation_tpu_torch.models.backbone import Conv2d
from relation_tpu_torch.ops.nms import nms_topk_presorted

_NEG_INF = -1e10


class RPNHead(nn.Module):
    """rpn_conv_3x3 -> relu -> {rpn_cls_score, rpn_bbox_pred}."""

    def __init__(self, cin: int, num_anchors: int):
        super().__init__()
        self.num_anchors = num_anchors
        self.rpn_conv_3x3 = Conv2d(cin, 512, 3, padding=1)
        self.rpn_cls_score = Conv2d(512, 2 * num_anchors, 1)
        self.rpn_bbox_pred = Conv2d(512, 4 * num_anchors, 1)

    def forward(self, feat: torch.Tensor):
        """feat NCHW -> (cls [B, H, W, A, 2], bbox [B, H, W, A, 4]) in f32;
        channel a*2+j is (anchor a, bg/fg j), a*4+j (anchor a, delta j)."""
        a = self.num_anchors
        x = F.relu(self.rpn_conv_3x3(feat))
        cls = self.rpn_cls_score(x).permute(0, 2, 3, 1)
        bbox = self.rpn_bbox_pred(x).permute(0, 2, 3, 1)
        return (cls.reshape(cls.shape[:-1] + (a, 2)).float(),
                bbox.reshape(bbox.shape[:-1] + (a, 4)).float())


def generate_proposals(fg_prob: torch.Tensor, deltas: torch.Tensor,
                       base_anchors: torch.Tensor, im_info: torch.Tensor,
                       feat_stride: int, pre_nms_top_n: int, post_nms_top_n: int,
                       nms_thresh: float, min_size: float):
    """Decode + NMS one image's RPN output into post_nms_top_n rois.

    fg_prob [H, W, A]; deltas [H, W, A, 4]; base_anchors [A, 4]; im_info [3].
    Returns (rois [post_N, 4], scores [post_N], real [post_N] bool). The
    flatten order is (a, h, w), as in the JAX package, so that ties break
    the same way; the filters become -inf score masks."""
    H, W, A = fg_prob.shape
    dev = fg_prob.device
    scores = fg_prob.permute(2, 0, 1).reshape(-1)
    d = deltas.permute(2, 3, 0, 1)                          # [A, 4, H, W]
    dx, dy, dw, dh = (d[:, i].reshape(-1) for i in range(4))

    base = base_anchors.to(device=dev, dtype=torch.float32)
    sx = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :] * feat_stride
    sy = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None] * feat_stride
    zero = torch.zeros((A, H, W), dtype=torch.float32, device=dev)
    ax1 = (base[:, 0, None, None] + sx + zero).reshape(-1)
    ay1 = (base[:, 1, None, None] + sy + zero).reshape(-1)
    ax2 = (base[:, 2, None, None] + sx + zero).reshape(-1)
    ay2 = (base[:, 3, None, None] + sy + zero).reshape(-1)

    aw = ax2 - ax1 + 1.0
    ah = ay2 - ay1 + 1.0
    acx = ax1 + 0.5 * (aw - 1.0)
    acy = ay1 + 0.5 * (ah - 1.0)
    pcx = dx * aw + acx
    pcy = dy * ah + acy
    pw = torch.exp(dw) * aw
    ph = torch.exp(dh) * ah
    zero1 = torch.zeros((), dtype=torch.float32, device=dev)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero1), hi)

    x1 = clip(pcx - 0.5 * (pw - 1.0), im_info[1] - 1)
    y1 = clip(pcy - 0.5 * (ph - 1.0), im_info[0] - 1)
    x2 = clip(pcx + 0.5 * (pw - 1.0), im_info[1] - 1)
    y2 = clip(pcy + 0.5 * (ph - 1.0), im_info[0] - 1)

    valid_h = torch.floor(im_info[0] / feat_stride).to(torch.int32)
    valid_w = torch.floor(im_info[1] / feat_stride).to(torch.int32)
    cell_ok = ((torch.arange(H, device=dev)[None, :, None] < valid_h)
               & (torch.arange(W, device=dev)[None, None, :] < valid_w))
    cell_ok = cell_ok.expand(A, H, W).reshape(-1)
    ms = min_size * im_info[2]
    size_ok = ((x2 - x1 + 1.0) >= ms) & ((y2 - y1 + 1.0) >= ms)
    masked = torch.where(cell_ok & size_ok, scores,
                         torch.full_like(scores, _NEG_INF))

    # lax.top_k order: descending, lower index first among ties
    k = min(pre_nms_top_n, masked.shape[0])
    top_scores, top_idx = torch.sort(masked, descending=True, stable=True)
    top_scores, top_idx = top_scores[:k], top_idx[:k]
    top_bT = torch.stack([x1[top_idx], y1[top_idx], x2[top_idx], y2[top_idx]])
    top_valid = top_scores > _NEG_INF / 2

    keep_idx, real = nms_topk_presorted(top_bT, top_scores, top_valid,
                                        nms_thresh, post_nms_top_n)
    return top_bT[:, keep_idx].T, top_scores[keep_idx], real
