"""On-device training-target assignment (port of relation_tpu/models/targets.py).

Per image, static shapes, no host round trip:

- anchor_targets     <- lib/rpn/rpn.py:80-243 (assign_anchor)
- sample_rois        <- operator_py/proposal_target.py:30-143 + core/rcnn.py:369-398
- ohem_select        <- operator_py/box_annotator_ohem.py:19-86
- nms_multi_target   <- operator_py/nms_multi_target.py:18-112

"Sample k of the eligible without replacement" is "keep the k best random
priorities among the eligible". The priorities are uniform vectors: drawn
here from ``generator``, or handed in as ``priorities=`` (the parity tests
hand both packages the same vectors, since the two frameworks' random
streams differ).

Ground-truth boxes arrive padded to a fixed count with a validity mask;
padded ROI rows get label -1, which the valid-normalised losses ignore.

The constant vectors (bbox means, stds and weights, the learned-NMS target
thresholds) may be tuples or f32 tensors on the boxes' device; the train
steps hand tensors made once, since a tensor made here from host values is
a blocking copy to the card on every call.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from relation_tpu_torch.ops.boxes import bbox_overlaps, bbox_transform

_NEG = -1e9


def _uniform(n: int, generator, device) -> torch.Tensor:
    """n uniform [0, 1) f32 values on ``device`` from ``generator`` (a
    generator of another device draws there and the values are moved)."""
    if generator is None:
        return torch.rand(n, device=device)
    return torch.rand(n, generator=generator,
                      device=generator.device).to(device)


def _draw(priorities, count: int, n: int, generator, device):
    """The ``count`` priority vectors of a sampler: the caller's, or drawn."""
    if priorities is not None:
        if len(priorities) != count:
            raise ValueError(f"expected {count} priority vectors, "
                             f"got {len(priorities)}")
        return [p.to(device=device, dtype=torch.float32)
                if isinstance(p, torch.Tensor) else
                torch.tensor(np.asarray(p), dtype=torch.float32, device=device)
                for p in priorities]
    return [_uniform(n, generator, device) for _ in range(count)]


def uniform_priorities(generator: torch.Generator, count: int, n: int,
                       device) -> tuple:
    """``count`` uniform vectors [n] drawn from ``generator`` in sequence,
    as ``anchor_targets`` (2: fg, bg) and sampled-mode ``sample_rois`` (4)
    draw them: a data-parallel step draws the whole batch's this way."""
    return tuple(_draw(None, count, n, generator, device))


def _keep_top(mask: torch.Tensor, priority: torch.Tensor, cap, k_max: int
              ) -> torch.Tensor:
    """True for the ``cap`` highest-``priority`` elements among ``mask`` (all
    of them if fewer). ``cap`` may be a tensor, at most ``k_max``. Among equal
    priorities the earlier index wins, as with lax.top_k (a stable
    descending sort)."""
    key = torch.where(mask, priority.to(torch.float32),
                      torch.full_like(priority, _NEG, dtype=torch.float32))
    k_max = min(int(k_max), key.shape[0])
    idx = torch.sort(key, descending=True, stable=True).indices[:k_max]
    keep = torch.zeros_like(mask, dtype=torch.bool)
    keep[idx] = torch.arange(k_max, device=key.device) < cap
    return keep & mask


def anchor_targets(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_valid: torch.Tensor, im_info: torch.Tensor,
                   generator: torch.Generator | None = None,
                   rpn_batch_size: int = 256, fg_fraction: float = 0.5,
                   positive_overlap: float = 0.7, negative_overlap: float = 0.3,
                   clobber_positives: bool = False, allowed_border: float = 0.0,
                   bbox_weights=(1.0, 1.0, 1.0, 1.0), priorities=None):
    """RPN anchor label/target assignment for one image.

    anchors [K, 4] full grid; gt_boxes [G, 5] (x1, y1, x2, y2, cls) padded;
    gt_valid [G] bool; im_info [3]; ``priorities`` = (fg [K], bg [K]).
    Returns (label [K] in {-1, 0, 1}, bbox_target [K, 4], bbox_weight [K, 4]).
    """
    K = anchors.shape[0]
    dev = anchors.device
    gt_valid = gt_valid.bool()
    inside = ((anchors[:, 0] >= -allowed_border) &
              (anchors[:, 1] >= -allowed_border) &
              (anchors[:, 2] < im_info[1] + allowed_border) &
              (anchors[:, 3] < im_info[0] + allowed_border))
    num_gt = gt_valid.sum()
    minus1 = torch.full((), -1.0, device=dev)
    overlaps = bbox_overlaps(anchors, gt_boxes[:, :4])           # [K, G]
    overlaps = torch.where(gt_valid[None, :], overlaps, minus1)
    overlaps = torch.where(inside[:, None], overlaps, minus1)

    max_overlaps, argmax_overlaps = overlaps.max(dim=1)
    max_overlaps = max_overlaps.clamp_min(0.0)                   # -1 rows -> 0
    gt_max = overlaps.max(dim=0).values                          # [G]
    # anchors reaching a per-gt max, ties included (rpn.py:169-171)
    is_gt_best = ((overlaps == gt_max[None, :]) & gt_valid[None, :]
                  & (gt_max[None, :] > 0)).any(dim=1)

    label = torch.full((K,), -1, dtype=torch.long, device=dev)
    neg = max_overlaps < negative_overlap
    pos = is_gt_best | (max_overlaps >= positive_overlap)
    if clobber_positives:
        label = torch.where(pos, 1, label)
        label = torch.where(neg, 0, label)
    else:
        label = torch.where(neg, 0, label)
        label = torch.where(pos, 1, label)
    label = torch.where(inside, label, -1)
    # no gt at all: every inside anchor is background (rpn.py:185-186)
    label = torch.where((num_gt == 0) & inside, 0, label)

    u_fg, u_bg = _draw(priorities, 2, K, generator, dev)
    num_fg_cap = int(fg_fraction * rpn_batch_size)
    fg_mask = label == 1
    fg_keep = _keep_top(fg_mask, u_fg, num_fg_cap, num_fg_cap)
    label = torch.where(fg_mask & ~fg_keep, -1, label)

    num_bg_cap = rpn_batch_size - (label == 1).sum()
    bg_mask = label == 0
    bg_keep = _keep_top(bg_mask, u_bg, num_bg_cap, rpn_batch_size)
    label = torch.where(bg_mask & ~bg_keep, -1, label)

    target = bbox_transform(anchors, gt_boxes[argmax_overlaps, :4])
    is_fg = label[:, None] == 1
    target = torch.where((num_gt > 0) & is_fg, target,
                         torch.zeros_like(target))
    w = torch.as_tensor(bbox_weights, dtype=torch.float32, device=dev)
    weight = torch.where(is_fg, w[None, :], torch.zeros((), device=dev))
    return label, target, weight


def expand_bbox_targets(labels: torch.Tensor, targets: torch.Tensor,
                        num_reg_classes: int, bbox_weights=(1.0, 1.0, 1.0, 1.0)):
    """[R] labels + [R, 4] targets -> one-hot-expanded [R, 4*num_reg_classes]
    targets and weights (lib/bbox/bbox_regression.py:117-140; class-agnostic
    puts every fg in group 1)."""
    R = labels.shape[0]
    if num_reg_classes == 2:
        group = (labels > 0).long()
    else:
        group = labels.clamp(0, num_reg_classes - 1)
    onehot = F.one_hot(group, num_reg_classes).to(torch.float32)  # [R, Krc]
    fg = (labels > 0).to(torch.float32)[:, None, None]
    expanded = onehot[:, :, None] * targets[:, None, :] * fg
    w = torch.as_tensor(bbox_weights, dtype=torch.float32, device=labels.device)
    weights = onehot[:, :, None] * w[None, None, :] * fg
    return expanded.reshape(R, -1), weights.reshape(R, -1)


def sample_rois(rois: torch.Tensor, roi_valid: torch.Tensor,
                gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                generator: torch.Generator | None = None, *,
                batch_rois: int, num_reg_classes: int, fg_fraction: float = 0.25,
                fg_thresh: float = 0.5, bg_thresh_hi: float = 0.5,
                bg_thresh_lo: float = 0.0, bbox_normalize: bool = False,
                bbox_means=(0., 0., 0., 0.), bbox_stds=(0.1, 0.1, 0.2, 0.2),
                bbox_weights=(1.0, 1.0, 1.0, 1.0), pad_mode: str = "repeat",
                priorities=None):
    """proposal_target: append the gt rois, FG/BG-sample (or take all), emit
    targets.

    rois [R, 4] (padding flagged by roi_valid); gt padded [G, 5]. Take-all
    mode (batch_rois < 0) keeps everything, R + G rows, and draws nothing;
    sampled mode gives exactly batch_rois rows, from ``priorities`` =
    (fg, bg, pad, gap), each [R + G]. ``pad_mode``: 'repeat' fills a short
    minibatch by a fresh draw over all valid rois (core/rcnn.py:369-373),
    'distinct' only from the rois not selected yet.

    Returns dict(rois [S, 4], label [S] (-1 ignore), bbox_target [S, 4*Krc],
    bbox_weight [S, 4*Krc]).
    """
    R, G = rois.shape[0], gt_boxes.shape[0]
    dev = rois.device
    gt_valid = gt_valid.bool()
    all_rois = torch.cat([rois, gt_boxes[:, :4]], dim=0)          # [R+G, 4]
    all_valid = torch.cat([roi_valid.bool(), gt_valid], dim=0)

    num_gt = gt_valid.sum()
    overlaps = bbox_overlaps(all_rois, gt_boxes[:, :4])           # [R+G, G]
    overlaps = torch.where(gt_valid[None, :], overlaps,
                           torch.full((), -1.0, device=dev))
    max_overlaps, gt_assignment = overlaps.max(dim=1)
    max_overlaps = max_overlaps.clamp_min(0.0)
    raw_label = gt_boxes[gt_assignment, 4].long()

    fg = all_valid & (max_overlaps >= fg_thresh) & (num_gt > 0)
    bg = all_valid & (max_overlaps < bg_thresh_hi) & (max_overlaps >= bg_thresh_lo)
    label = torch.where(fg, raw_label, torch.where(bg, 0, -1))

    if batch_rois < 0:
        sel_rois, sel_label = all_rois, label
        sel_assignment, sel_fg = gt_assignment, fg
    else:
        u_fg, u_bg, u_pad, u_gap = _draw(priorities, 4, R + G, generator, dev)
        fg_cap = int(round(fg_fraction * batch_rois))
        fg_sel = _keep_top(fg, u_fg, fg_cap, fg_cap)
        n_fg = fg_sel.sum()
        bg_sel = _keep_top(bg, u_bg, batch_rois - n_fg, batch_rois)
        n_keep = n_fg + bg_sel.sum()
        # selected fg (0) < selected bg (1) < rest (2), random within
        key = torch.where(fg_sel, 0.0, torch.where(bg_sel, 1.0, 2.0))
        key = key.to(torch.float32) + u_pad * 0.5
        far = torch.full((), 1e6, device=dev)
        key = torch.where(all_valid, key, far)                   # padding last
        sel_order = torch.argsort(key, stable=True)
        if pad_mode == "repeat":
            gap_perm = torch.argsort(torch.where(all_valid, u_gap, far),
                                     stable=True)
            p = torch.arange(batch_rois, device=dev)
            # a minibatch larger than the roi set cycles no further than the
            # last row, as the clipped index of the JAX package does
            order = torch.where(
                p < n_keep, sel_order[p.clamp_max(R + G - 1)],
                gap_perm[(p - n_keep).clamp(0, R + G - 1)])
        else:
            order = sel_order[:batch_rois]
        sel_rois = all_rois[order]
        raw = label[order]
        # gap rows are labelled by their own overlap (rcnn.py:380-382)
        sel_label = torch.where(
            raw == -1,
            torch.where(max_overlaps[order] >= bg_thresh_hi, raw_label[order], 0),
            raw)
        sel_label = torch.where(all_valid[order], sel_label, -1)
        sel_assignment = gt_assignment[order]
        sel_fg = sel_label > 0

    targets = bbox_transform(sel_rois, gt_boxes[sel_assignment, :4])
    if bbox_normalize:
        targets = (targets - torch.as_tensor(bbox_means, dtype=torch.float32,
                                             device=dev)) \
            / torch.as_tensor(bbox_stds, dtype=torch.float32, device=dev)
    targets = torch.where((num_gt > 0) & sel_fg[:, None], targets,
                          torch.zeros_like(targets))
    bbox_target, bbox_weight = expand_bbox_targets(
        torch.where(sel_fg, sel_label, 0), targets, num_reg_classes, bbox_weights)
    return {"rois": sel_rois, "label": sel_label,
            "bbox_target": bbox_target, "bbox_weight": bbox_weight}


def ohem_select(cls_score: torch.Tensor, bbox_pred: torch.Tensor,
                label: torch.Tensor, bbox_target: torch.Tensor,
                bbox_weight: torch.Tensor, roi_per_img: int):
    """Online hard example mining: keep the roi_per_img highest-loss ROIs
    (BoxAnnotatorOHEM). Per-ROI loss is cls NLL + smooth-l1 bbox loss; ROIs
    not kept get label -1 / weight 0; ignored rows never win a slot. The
    selection carries no gradient."""
    with torch.no_grad():
        logp = F.log_softmax(cls_score, dim=-1)
        safe = label.clamp(0, cls_score.shape[-1] - 1)
        cls_loss = -logp.gather(1, safe[:, None])[:, 0]
        diff = (bbox_pred - bbox_target).abs()
        sl1 = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
        box_loss = (bbox_weight * sl1).sum(dim=1)
        per_roi = torch.where(label >= 0, cls_loss + box_loss,
                              torch.full_like(cls_loss, _NEG))
        keep = _keep_top(label >= 0, per_roi, roi_per_img, roi_per_img)
    return (torch.where(keep, label, -1),
            torch.where(keep[:, None], bbox_weight,
                        torch.zeros((), device=label.device)))


def nms_multi_target(sorted_bbox: torch.Tensor, gt_boxes: torch.Tensor,
                     gt_valid: torch.Tensor, sorted_score: torch.Tensor,
                     target_thresh) -> torch.Tensor:
    """Learned-NMS training target: per (fg class, IoU threshold), mark the
    one max-score box among those whose best-overlap gt it is, mAP-style
    (operator_py/nms_multi_target.py:24-74).

    sorted_bbox [F, C, 4]; gt_boxes [G, 5] padded; sorted_score [F, C];
    target_thresh: T thresholds -> [F, C, T] f32 (no gradient)."""
    Fn, C, _ = sorted_bbox.shape
    G = gt_boxes.shape[0]
    dev = sorted_bbox.device
    with torch.no_grad():
        thr = torch.as_tensor(target_thresh, dtype=torch.float32, device=dev)
        cls = gt_boxes[:, 4].long()
        valid_g = gt_valid.bool()[None, :] & (
            cls[None, :] == torch.arange(1, C + 1, device=dev)[:, None])  # [C, G]
        ov = bbox_overlaps(sorted_bbox.reshape(Fn * C, 4),
                           gt_boxes[:, :4]).reshape(Fn, C, G)
        ov_valid = torch.where(valid_g[None], ov,
                               torch.full((), -1.0, device=dev))
        best_onehot = F.one_hot(ov_valid.argmax(dim=2), G).to(torch.float32)
        mask = ov_valid[None] > thr[:, None, None, None]         # [T, F, C, G]
        has_any = mask.any(dim=3)                                # [T, F, C]
        oscore = sorted_score[None, :, :, None] * mask * best_onehot[None]
        winner = oscore.argmax(dim=1)                            # [T, C, G]
        marked = (F.one_hot(winner, Fn).bool()
                  & valid_g[None, :, :, None]).any(dim=2)        # [T, C, F]
        out = marked.permute(2, 1, 0) & has_any.permute(1, 2, 0)  # [F, C, T]
        out = out & valid_g.any(dim=1)[None, :, None]
    return out.to(torch.float32)
