"""Loss assembly with the reference's scaling conventions (port of
relation_tpu/models/losses.py; symbols/..._learn_nms.py):

- RPN cls: SoftmaxOutput(normalization='valid', ignore -1)           (:272-273)
- RPN bbox: weight * smooth_l1(sigma=3) / RPN_BATCH_SIZE             (:276-278)
- RCNN cls: SoftmaxOutput(normalization='valid' [, ignore -1 OHEM])  (:372-380)
- RCNN bbox: weight * smooth_l1(sigma=1) / batch_rois                (:374-387)
- learned NMS: binary CE, scale nms_loss_scale/(first_n*num_thresh),
  the positive term times nms_pos_scale                              (:539-551)

``normalization='valid'`` is a mean over the rows that are not ignored.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def smooth_l1(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """MXNet smooth_l1 with ``scalar=sigma``: 0.5*(sigma*x)^2 if
    |x| < 1/sigma^2 else |x| - 0.5/sigma^2."""
    s2 = sigma * sigma
    ax = x.abs()
    return torch.where(ax < 1.0 / s2, 0.5 * s2 * x * x, ax - 0.5 / s2)


def softmax_ce_valid(logits: torch.Tensor, labels: torch.Tensor):
    """Cross-entropy, mean over labels >= 0 (ignore label -1).
    Returns (loss, num_valid)."""
    valid = labels >= 0
    safe = labels.clamp(0, logits.shape[-1] - 1)
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    num = valid.to(torch.float32).sum().clamp_min(1.0)
    return torch.where(valid, nll, torch.zeros_like(nll)).sum() / num, num


def rpn_losses(rpn_cls_logits: torch.Tensor, rpn_bbox_pred: torch.Tensor,
               label: torch.Tensor, bbox_target: torch.Tensor,
               bbox_weight: torch.Tensor, rpn_batch_size: int,
               sigma: float = 3.0):
    """rpn_cls_logits [K, 2] (K = h*w*A, (h, w, a)-major); label [K] in
    {-1, 0, 1}; bbox_* [K, 4]."""
    cls_loss, _ = softmax_ce_valid(rpn_cls_logits, label)
    l1 = bbox_weight * smooth_l1(rpn_bbox_pred - bbox_target, sigma)
    return cls_loss, l1.sum() / rpn_batch_size


def rcnn_losses(cls_score: torch.Tensor, bbox_pred: torch.Tensor,
                label: torch.Tensor, bbox_target: torch.Tensor,
                bbox_weight: torch.Tensor, bbox_norm: float):
    """cls_score [R, C]; label [R] (-1 ignored); bbox_norm = BATCH_ROIS_OHEM
    or the reference's batch_rois_num (300 when BATCH_ROIS < 0)."""
    cls_loss, _ = softmax_ce_valid(cls_score, label)
    l1 = bbox_weight * smooth_l1(bbox_pred - bbox_target, 1.0)
    return cls_loss, l1.sum() / bbox_norm


def learn_nms_losses(nms_multi_score: torch.Tensor,
                     nms_multi_target: torch.Tensor, nms_loss_scale: float,
                     nms_pos_scale: float, eps: float = 1e-8):
    """Binary CE split into pos/neg terms (reference :539-551), shapes
    [F, C, T]. The score is clamped strictly below 1 (1 - 1e-7), as in the
    JAX package: softmax * sigmoid saturates to exactly 1.0f, and
    log(1 - s + eps) must stay finite there."""
    first_n, _, num_thresh = nms_multi_score.shape
    normalizer = first_n * num_thresh
    s = nms_multi_score.clamp(0.0, 1.0 - 1e-7)
    pos = -nms_multi_target * torch.log(s + eps)
    neg = -(1.0 - nms_multi_target) * torch.log(1.0 - s + eps)
    pos_loss = nms_loss_scale * pos.sum() / normalizer
    neg_loss = nms_loss_scale * neg.sum() / normalizer
    return nms_pos_scale * pos_loss + neg_loss, pos_loss, neg_loss


def accuracy_ignore(logits: torch.Tensor, labels: torch.Tensor):
    """Valid-normalised accuracy (reference core/metric.py RCNNAccMetric)."""
    pred = logits.argmax(dim=-1)
    valid = labels >= 0
    num = valid.to(torch.float32).sum().clamp_min(1.0)
    return (valid & (pred == labels)).to(torch.float32).sum() / num


def nms_accuracy(nms_multi_score: torch.Tensor, nms_multi_target: torch.Tensor):
    """Pos/neg accuracy of the score at 0.5 (core/metric.py NMSAccMetric)."""
    pred_pos = nms_multi_score > 0.5
    pos_mask = nms_multi_target > 0.5
    num_pos = pos_mask.to(torch.float32).sum().clamp_min(1.0)
    num_neg = (~pos_mask).to(torch.float32).sum().clamp_min(1.0)
    acc_pos = (pos_mask & pred_pos).to(torch.float32).sum() / num_pos
    acc_neg = (~pos_mask & ~pred_pos).to(torch.float32).sum() / num_neg
    return acc_pos, acc_neg
