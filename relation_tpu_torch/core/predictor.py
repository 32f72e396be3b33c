"""Single-image inference with on-device post-processing (port of
relation_tpu/core/predictor.py::make_predict_fn: the C4 branch with the
learned-NMS tail or the classic tail, greedy per-class NMS or soft-NMS).

Detections come back as a fixed-size [max_det, 6] tensor (cls_id, score,
x1, y1, x2, y2 in original-image coordinates) with -1 class padding.
The FPN / split / sharded / rcnn variants come in later slices of the port.
"""

from __future__ import annotations

import torch

from relation_tpu_torch.models.detector import RelationRCNN
from relation_tpu_torch.models.learn_nms import merge_multi_score
from relation_tpu_torch.models.rpn import generate_proposals
from relation_tpu_torch.ops.anchors import generate_anchors
from relation_tpu_torch.ops.boxes import bbox_pred, clip_boxes
from relation_tpu_torch.ops.nms import classwise_nms, soft_nms

_NEG_INF = -1e10


def _image_from_u8(image: torch.Tensor, im_info: torch.Tensor, pixel_means):
    """Device-side mean subtraction and pad re-zeroing for uint8 inputs, s2d
    planar [12, H/2, W/2] or NHWC [H, W, 3]; other dtypes pass through."""
    if image.dtype != torch.uint8:
        return image
    dev = image.device
    means = torch.as_tensor(pixel_means, dtype=torch.float32, device=dev).reshape(-1)
    h, w = im_info[0], im_info[1]
    if image.dim() == 3 and image.shape[0] == 12 and image.shape[-1] != 3:
        k = torch.arange(12, device=dev)
        x = image.float() - means[k % 3][:, None, None]
        hh, ww = image.shape[1], image.shape[2]
        row_ok = (2.0 * torch.arange(hh, device=dev)[None, :] + (k // 6)[:, None]) < h
        col_ok = (2.0 * torch.arange(ww, device=dev)[None, :]
                  + ((k // 3) % 2)[:, None]) < w
        return x * (row_ok[:, :, None] & col_ok[:, None, :])
    x = image.float() - means[None, None, :]
    row_ok = torch.arange(image.shape[0], dtype=torch.float32,
                          device=dev)[:, None, None] < h
    col_ok = torch.arange(image.shape[1], dtype=torch.float32,
                          device=dev)[None, :, None] < w
    return x * (row_ok & col_ok)


def _topk_detections(cls_ids, scores, boxes, valid, max_det: int):
    """Global max_per_image cut over all classes, padded: [max_det, 6].
    lax.top_k order: descending, lower index first among ties."""
    masked = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
    top_scores, idx = torch.sort(masked, descending=True, stable=True)
    top_scores, idx = top_scores[:max_det], idx[:max_det]
    real = top_scores > _NEG_INF / 2
    return torch.cat([
        torch.where(real, cls_ids[idx], -1)[:, None].to(torch.float32),
        torch.where(real, top_scores, torch.zeros_like(top_scores))[:, None],
        boxes[idx] * real[:, None],
    ], dim=1)


def make_predict_fn(model: RelationRCNN, cfg):
    """Build the single-image inference function of a C4 model (plain,
    relation, DCN; learned-NMS tail when TEST.LEARN_NMS, else the classic
    tail: per-class greedy NMS, or soft-NMS when TEST.SOFTNMS).

    Returns predict(image, im_info) -> dict with 'dets' [max_per_image, 6]
    and the intermediate outputs (rois, roi_scores, cls_score, bbox_pred,
    fc2, and nms_multi_score, sorted_bbox, sorted_score, final_score of the
    learned-NMS tail or cls_prob, pred_boxes of the classic one). image is
    s2d planar [12, H/2, W/2] or NHWC [H, W, 3] (f32, or uint8 before mean
    subtraction); im_info [3] = (h, w, scale). Inputs may live on the host:
    they are moved to the model's device."""
    stride = int(cfg.network.RPN_FEAT_STRIDE)
    device = next(model.parameters()).device
    base_anchors = torch.as_tensor(
        generate_anchors(stride, tuple(cfg.network.ANCHOR_RATIOS),
                         tuple(cfg.network.ANCHOR_SCALES)),
        dtype=torch.float32, device=device)
    nongt_dim = int(cfg.TEST.RPN_POST_NMS_TOP_N)
    max_det = int(cfg.TEST.max_per_image)
    merge_method = int(cfg.TEST.MERGE_METHOD)
    score_thresh = float(cfg.TEST.get("SCORE_THRESH", 1e-3))
    class_thresh = float(cfg.TEST.LEARN_NMS_CLASS_SCORE_TH)
    pixel_means = tuple(float(m) for m in cfg.network.PIXEL_MEANS)
    pre_n, post_n = int(cfg.TEST.RPN_PRE_NMS_TOP_N), int(cfg.TEST.RPN_POST_NMS_TOP_N)
    rpn_thresh = float(cfg.TEST.RPN_NMS_THRESH)
    min_size = float(cfg.TEST.RPN_MIN_SIZE)
    learn_nms = bool(cfg.TEST.LEARN_NMS)
    softnms = bool(cfg.TEST.SOFTNMS)
    nms_thresh = float(cfg.TEST.NMS)
    num_classes = int(cfg.dataset.NUM_CLASSES)
    class_agnostic = bool(cfg.CLASS_AGNOSTIC)
    precomputed = bool(cfg.TRAIN.BBOX_NORMALIZATION_PRECOMPUTED)
    stds = tuple(cfg.TRAIN.BBOX_STDS) if precomputed else None
    means = tuple(cfg.TRAIN.BBOX_MEANS) if precomputed else None

    def classic_tail(cls_score, bbox_deltas, rois, roi_real, im_info):
        """softmax -> decoded, clipped boxes -> per-class NMS -> top
        max_det over all classes (relation_tpu/core/predictor.py:198-246)."""
        cls_prob = torch.softmax(cls_score, dim=-1)                 # [N, K]
        deltas = bbox_deltas
        if stds is not None:
            # undo the train-time target normalisation
            k = deltas.shape[1] // 4
            deltas = (deltas.reshape(-1, k, 4) * deltas.new_tensor(stds)
                      + deltas.new_tensor(means)).reshape(-1, 4 * k)
        boxes_all = clip_boxes(bbox_pred(rois, deltas), (im_info[0], im_info[1]))
        boxes_all = boxes_all / im_info[2]                          # [N, 4K]
        N = cls_prob.shape[0]
        fg = num_classes - 1
        scores_t = cls_prob[:, 1:].t().contiguous()                 # [C, N]
        if class_agnostic:
            boxes_c = boxes_all.reshape(N, -1, 4)[:, 1][None].expand(fg, N, 4)
        else:
            boxes_c = boxes_all.reshape(N, -1, 4)[:, 1:].transpose(0, 1)
        boxes_c = boxes_c.contiguous()
        valid = (scores_t > score_thresh) & roi_real[None, :]
        ids = torch.arange(1, fg + 1, device=device)[:, None]
        if softnms:
            idx, ks, kv = soft_nms(boxes_c, scores_t, nms_thresh, max_det,
                                   valid, score_floor=score_thresh)
            kb = torch.gather(boxes_c, 1, idx[..., None].expand(-1, -1, 4))
            dets = _topk_detections(ids.expand_as(idx).reshape(-1),
                                    ks.reshape(-1), kb.reshape(-1, 4),
                                    kv.reshape(-1), max_det)
        else:
            keep = classwise_nms(boxes_c, scores_t, nms_thresh, score_thresh,
                                 valid=valid, max_keep=max_det)     # [C, N]
            dets = _topk_detections(ids.expand_as(keep).reshape(-1),
                                    scores_t.reshape(-1),
                                    boxes_c.reshape(-1, 4), keep.reshape(-1),
                                    max_det)
        return {"dets": dets, "cls_prob": cls_prob, "pred_boxes": boxes_all}

    def learned_tail(cls_score, bbox_deltas, rois, fc2, im_info):
        """learned-NMS head -> merged scores -> top max_det."""
        ln = model.learn_nms(cls_score, bbox_deltas, rois, fc2, im_info,
                             class_thresh)
        final = merge_multi_score(ln["nms_multi_score"], merge_method)  # [F, C]
        boxes = ln["sorted_bbox"] / im_info[2]
        F_, C = final.shape
        cls_ids = torch.arange(1, C + 1, device=device)[None, :].expand(F_, C)
        dets = _topk_detections(cls_ids.reshape(-1), final.reshape(-1),
                                boxes.reshape(-1, 4),
                                (final > score_thresh).reshape(-1), max_det)
        return {"dets": dets, "nms_multi_score": ln["nms_multi_score"],
                "sorted_bbox": ln["sorted_bbox"],
                "sorted_score": ln["sorted_score"], "final_score": final}

    def tail(cls_score, bbox_deltas, fc2, rois, roi_real, im_info):
        if learn_nms:
            return learned_tail(cls_score, bbox_deltas, rois, fc2, im_info)
        return classic_tail(cls_score, bbox_deltas, rois, roi_real, im_info)

    @torch.inference_mode()
    def predict(image, im_info):
        image = torch.as_tensor(image, device=device)
        im_info = torch.as_tensor(im_info, dtype=torch.float32, device=device)
        image = _image_from_u8(image, im_info, pixel_means)
        feat, rpn_cls, rpn_bbox = model.features_and_rpn(image)
        fg_prob = torch.softmax(rpn_cls, dim=-1)[..., 1]
        rois, roi_scores, roi_real = generate_proposals(
            fg_prob, rpn_bbox, base_anchors, im_info, stride, pre_n, post_n,
            rpn_thresh, min_size)
        cls_score, bbox_deltas, fc2 = model.head(feat, rois, nongt_dim)
        out = {"rois": rois, "roi_scores": roi_scores, "roi_real": roi_real,
               "feat": feat, "rpn_cls": rpn_cls, "rpn_bbox": rpn_bbox,
               "cls_score": cls_score, "bbox_pred": bbox_deltas, "fc2": fc2}
        out.update(tail(cls_score, bbox_deltas, fc2, rois, roi_real, im_info))
        return out

    predict.tail = tail         # the stage after the head, for the profiler
    return predict
