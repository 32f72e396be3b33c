"""Single-image inference with on-device post-processing (port of
relation_tpu/core/predictor.py::make_predict_fn, C4 and FPN, with the
learned-NMS tail or the classic tail, greedy per-class NMS or soft-NMS;
make_predict_fn_split of the FPN learned-NMS family, which also serves its
three-program form; and core/evaluator.py::_build_predict_fn, which picks
among them).

Detections come back as a fixed-size [max_det, 6] tensor (cls_id, score,
x1, y1, x2, y2 in original-image coordinates) with -1 class padding.
make_predict_fn_rcnn predicts from cached proposals (TEST.HAS_RPN false);
make_predict_fn_sharded predicts a group of images over a data-parallel
process group (parallel/mesh.py), one image a rank.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from relation_tpu_torch.models.backbone import fold_res4_params
from relation_tpu_torch.models.detector import RelationRCNN
from relation_tpu_torch.models.fpn import (FPN_STRIDES, RelationRCNNFPN,
                                           generate_proposals_fpn)
from relation_tpu_torch.models.learn_nms import merge_multi_score
from relation_tpu_torch.models.rpn import generate_proposals
from relation_tpu_torch.ops.anchors import generate_anchors
from relation_tpu_torch.ops.boxes import bbox_pred, clip_boxes
from relation_tpu_torch.ops.nms import classwise_nms, soft_nms
from relation_tpu_torch.utils import trace
from relation_tpu_torch.utils.debug import tensor_stats

_NEG_INF = -1e10


def pixel_means_tensor(cfg, device) -> torch.Tensor:
    """cfg.network.PIXEL_MEANS (BGR) as an f32 tensor [3] on ``device``, for
    ``_image_from_u8``. Made once where a step or a predict function is
    built: a tensor made from host values inside a step or a request is a
    copy from pageable memory, which blocks the host until the card has run
    everything queued before it."""
    return torch.tensor([float(m) for m in cfg.network.PIXEL_MEANS],
                        dtype=torch.float32, device=device)


def _image_from_u8(image: torch.Tensor, im_info: torch.Tensor,
                   means: torch.Tensor):
    """Device-side mean subtraction and pad re-zeroing for a batch of uint8
    images, s2d planar [B, 12, H/2, W/2] or NHWC [B, H, W, 3], with
    ``im_info`` [B, 3]; ``means`` is ``pixel_means_tensor``'s, on the
    images' device (one image: ``image[None]``, ``im_info[None]``). Other
    dtypes pass through. Nothing is made from host values, so nothing here
    waits on the device."""
    if image.dtype != torch.uint8:
        return image
    dev = image.device
    h, w = im_info[:, 0], im_info[:, 1]
    if image.shape[1] == 12 and image.shape[-1] != 3:
        k = torch.arange(12, device=dev)
        x = image.float() - means[k % 3][:, None, None]
        hh, ww = image.shape[2], image.shape[3]
        row_ok = (2.0 * torch.arange(hh, device=dev)[None, :]
                  + (k // 6)[:, None])[None] < h[:, None, None]
        col_ok = (2.0 * torch.arange(ww, device=dev)[None, :]
                  + ((k // 3) % 2)[:, None])[None] < w[:, None, None]
        return x * (row_ok[:, :, :, None] & col_ok[:, :, None, :])
    x = image.float() - means
    row_ok = torch.arange(image.shape[1], dtype=torch.float32,
                          device=dev)[None, :] < h[:, None]
    col_ok = torch.arange(image.shape[2], dtype=torch.float32,
                          device=dev)[None, :] < w[:, None]
    return x * (row_ok[:, :, None, None] & col_ok[:, None, :, None])


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


def prepare_res4_folded(model: RelationRCNN, enabled: bool = False):
    """The BN-folded res4b1..b22 weight stacks that switch the trunk to the
    fused stack kernel (backbone.fold_res4_params), in the trunk's dtype, or
    None when ``enabled`` (cfg.TPU.FUSE_RES4) is off or the model has no
    ResNet-101 C4 trunk (relation_tpu/core/predictor.py::
    prepare_res4_folded). Pass the result to ``predict(..., res4_folded)``.

    The folds are computed once and kept with the model; a change to any of
    the weights they read (load_state_dict, an update in place) makes the
    next call fold again. Unlike the JAX function this returns the folds on
    the CPU too: there the stack runs its plain PyTorch version, not an
    interpreter."""
    if not enabled or model.backbone != "resnet101":
        return None
    c4 = model.c4
    tensors = [t for u in c4.units(4)[1:]
               for t in itertools.chain(u.parameters(), u.buffers())]
    key = (c4.dtype, tensors[0].device) + tuple(
        (t.data_ptr(), t._version) for t in tensors)
    cached = model.__dict__.get("_res4_folded")
    if cached is None or cached[0] != key:
        cached = model.__dict__["_res4_folded"] = (
            key, fold_res4_params(c4, c4.dtype))
    return cached[1]


def make_predict_fn(model: RelationRCNN | RelationRCNNFPN, cfg,
                    tail_allow_pallas: bool | None = None):
    """Build the single-image inference function of a C4 model (plain,
    relation, DCN) or an FPN model; learned-NMS tail when TEST.LEARN_NMS,
    else the classic tail: per-class greedy NMS, or soft-NMS when
    TEST.SOFTNMS. ``tail_allow_pallas`` (FPN only: the split form's
    tail) overrides the learned-NMS attention's branch
    (NMSRelationModule.allow_pallas) for this function's requests.

    Returns predict(image, im_info, res4_folded=None) -> dict with 'dets'
    [max_per_image, 6]
    and the intermediate outputs (rois, roi_scores, cls_score, bbox_pred,
    fc2, and nms_multi_score, sorted_bbox, sorted_score, final_score of the
    learned-NMS tail or cls_prob, pred_boxes of the classic one; with
    TPU.DEBUG_MONITOR, 'monitor': {name: [min, max, mean]} of rois,
    cls_score, bbox_deltas and dets, utils/debug.py::tensor_stats). image is
    s2d planar [12, H/2, W/2] or NHWC [H, W, 3] (f32, or uint8 before mean
    subtraction); im_info [3] = (h, w, scale). Inputs may live on the host:
    they are moved to the model's device. ``res4_folded``
    (``prepare_res4_folded``) runs res4b1..b22 as the fused stack kernel.

    An FPN model decodes the RPN of the five pyramid levels, merges them
    (``generate_proposals_fpn``; TPU.FPN_TOPK is accepted and the top-k is
    always exact) and pools each ROI at its dispatch level; 'feat' is then
    the {stride: [h, w, 256]} pyramid and 'rpn_cls' / 'rpn_bbox' are
    {stride: raw conv layout} dicts."""
    stride = int(cfg.network.RPN_FEAT_STRIDE)
    device = next(model.parameters()).device
    is_fpn = isinstance(model, RelationRCNNFPN)
    if tail_allow_pallas is not None and not is_fpn:
        raise ValueError("tail_allow_pallas applies to an FPN model only")
    tail_kw = {} if tail_allow_pallas is None else {
        "allow_pallas": tail_allow_pallas}
    ratios = tuple(cfg.network.ANCHOR_RATIOS)
    scales = tuple(cfg.network.ANCHOR_SCALES)
    if is_fpn:
        # base anchors of each level: base size = the level's stride
        base_anchors = {s: torch.as_tensor(generate_anchors(s, ratios, scales),
                                           dtype=torch.float32, device=device)
                        for s in FPN_STRIDES}
    else:
        base_anchors = torch.as_tensor(generate_anchors(stride, ratios, scales),
                                       dtype=torch.float32, device=device)
    nongt_dim = int(cfg.TEST.RPN_POST_NMS_TOP_N)
    max_det = int(cfg.TEST.max_per_image)
    merge_method = int(cfg.TEST.MERGE_METHOD)
    score_thresh = float(cfg.TEST.get("SCORE_THRESH", 1e-3))
    class_thresh = float(cfg.TEST.LEARN_NMS_CLASS_SCORE_TH)
    pixel_means = pixel_means_tensor(cfg, device)
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
    # test.py --debug: the taps of the reference's monitor op
    # (operator_py/monitor_op.py), returned as out["monitor"]
    debug_monitor = bool(cfg.TPU.get("DEBUG_MONITOR", False))

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

    def learned_tail(cls_score, bbox_deltas, rois, fc2, im_info,
                     class_thresh=class_thresh):
        """learned-NMS head -> merged scores -> top max_det."""
        ln = model.learn_nms(cls_score, bbox_deltas, rois, fc2, im_info,
                             class_thresh, **tail_kw)
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
    @trace.span("predict", request=True)
    def predict(image, im_info, res4_folded=None):
        with trace.span("predict.input"):
            image = torch.as_tensor(image, device=device)
            im_info = torch.as_tensor(im_info, dtype=torch.float32, device=device)
            image = _image_from_u8(image[None], im_info[None],
                                   pixel_means)[0]
        if is_fpn:
            with trace.span("predict.trunk_rpn"):
                feat, rpn_out = model.features_and_rpn(image)
            rpn_cls = {s: c for s, (c, _) in rpn_out.items()}
            rpn_bbox = {s: b for s, (_, b) in rpn_out.items()}
            with trace.span("predict.proposals"):
                rois, roi_scores, roi_real = generate_proposals_fpn(
                    rpn_out, base_anchors, im_info, pre_n, post_n, rpn_thresh,
                    min_size)
        else:
            with trace.span("predict.trunk_rpn"):
                feat, rpn_cls, rpn_bbox = model.features_and_rpn(image,
                                                                 res4_folded)
            with trace.span("predict.proposals"):
                fg_prob = torch.softmax(rpn_cls, dim=-1)[..., 1]
                rois, roi_scores, roi_real = generate_proposals(
                    fg_prob, rpn_bbox, base_anchors, im_info, stride, pre_n,
                    post_n, rpn_thresh, min_size)
        with trace.span("predict.head"):
            cls_score, bbox_deltas, fc2 = model.head(feat, rois, nongt_dim)
        out = {"rois": rois, "roi_scores": roi_scores, "roi_real": roi_real,
               "feat": feat, "rpn_cls": rpn_cls, "rpn_bbox": rpn_bbox,
               "cls_score": cls_score, "bbox_pred": bbox_deltas, "fc2": fc2}
        with trace.span("predict.tail"):
            out.update(tail(cls_score, bbox_deltas, fc2, rois, roi_real,
                            im_info))
        if debug_monitor:
            out["monitor"] = {name: tensor_stats(x) for name, x in (
                ("rois", rois), ("cls_score", cls_score),
                ("bbox_deltas", bbox_deltas), ("dets", out["dets"]))}
        return out

    predict.tail = tail         # the stage after the head, for the profiler
    predict.classic_tail, predict.learned_tail = classic_tail, learned_tail
    return predict


def make_predict_fn_split(model: RelationRCNNFPN, cfg):
    """FPN learned-NMS inference in the form of the JAX package's
    TPU.FPN_SPLIT_PREDICT (relation_tpu/core/predictor.py:255-331): trunk,
    pyramid, proposals and head as in ``make_predict_fn``, then the
    learned-NMS tail with ``allow_pallas=True`` (the fused skip attention at
    most C/2 active classes, else geometric bias + bias attention). The
    JAX package splits the two into XLA programs only to keep its Pallas
    calls out of the pyramid's compilation; here it is one eager program
    and the math is the same. Same call signature and result dict as
    make_predict_fn."""
    if not (isinstance(model, RelationRCNNFPN) and bool(cfg.TEST.LEARN_NMS)):
        raise ValueError("FPN_SPLIT_PREDICT applies to the FPN learned-NMS "
                         "predict path only")
    return make_predict_fn(model, cfg, tail_allow_pallas=True)


def build_predict_fn(model: RelationRCNN | RelationRCNNFPN, cfg):
    """The predict function a user of a config gets (relation_tpu/core/
    evaluator.py::_build_predict_fn): the split form for the FPN learned-NMS
    family when TPU.FPN_SPLIT_PREDICT is truthy, the single module otherwise.
    FPN_SPLIT_PREDICT = 3 is the JAX package's third program
    (relation_tpu/core/predictor.py:334-425), which adds the Pallas proposal
    NMS and the Pallas geometric bias of the head's relation modules to the
    split form; the port runs both as kernels on every path, so 3 is the
    split form too."""
    if (cfg.TPU.get("FPN_SPLIT_PREDICT", False)
            and isinstance(model, RelationRCNNFPN) and bool(cfg.TEST.LEARN_NMS)):
        return make_predict_fn_split(model, cfg)
    return make_predict_fn(model, cfg)


def make_predict_fn_sharded(model: RelationRCNN | RelationRCNNFPN, cfg, mesh):
    """Data-parallel inference over a process group (parallel/mesh.py), the
    counterpart of the JAX package's make_predict_fn_sharded (shard_map of
    the single-image predict over the mesh's data axis; the reference's
    multi-GPU Predictor, one executor a context, core/tester.py:27-40):
    ``world`` images a call, one a rank, each rank running the unchanged
    single-image predict function (``build_predict_fn``). No collective
    touches the model: the detections are gathered to every rank as CPU
    arrays (``gather_objects``), in rank order.

    Returns fn(image, im_info, res4_folded=None) -> dets [world, max_det, 6]
    numpy, the same on every rank: each rank passes its own image of the
    group (only that one is decoded) and gets row r from rank r. One
    function serves every bucket (the JAX package compiles one a
    bucket)."""
    from relation_tpu_torch.parallel.mesh import gather_objects
    predict = build_predict_fn(model, cfg)

    def fn(image, im_info, res4_folded=None):
        dets = predict(image, im_info, res4_folded)["dets"]
        return np.stack(gather_objects(mesh, dets.cpu().numpy()))
    return fn


def make_predict_fn_rcnn(model: RelationRCNN | RelationRCNNFPN, cfg):
    """Inference from cached proposals (TEST.HAS_RPN false; port of
    relation_tpu/core/predictor.py::make_predict_fn_rcnn): the trunk, then
    the head over the given ROIs, with every ROI a key of its relation
    modules (nongt_dim = the number of ROIs), then the tails of
    ``make_predict_fn``.

    Returns predict(image, im_info, rois [R, 4], rois_valid [R]) -> dict with
    'rois', 'dets' [max_per_image, 6] and the tail's outputs, on the model's
    device (inputs may live on the host). TOP_ROIS is the caller's cut;
    padding rides on ``rois_valid``. Where the JAX function differs from
    make_predict_fn, this follows it:
      - the learned-NMS tail runs with no class threshold (0.0: every class
        active, so its dense branch runs), whatever
        TEST.LEARN_NMS_CLASS_SCORE_TH says;
      - the learned-NMS tail ignores ``rois_valid``: padded ROIs reach the
        head, and its relation modules take them as keys. Only the classic
        tail masks them."""
    device = next(model.parameters()).device
    learn_nms = bool(cfg.TEST.LEARN_NMS)
    pixel_means = pixel_means_tensor(cfg, device)
    base = make_predict_fn(model, cfg)

    @torch.inference_mode()
    @trace.span("predict", request=True)
    def predict(image, im_info, rois, rois_valid):
        with trace.span("predict.input"):
            image = torch.as_tensor(image, device=device)
            im_info = torch.as_tensor(im_info, dtype=torch.float32, device=device)
            rois = torch.as_tensor(rois, dtype=torch.float32, device=device)
            rois_valid = torch.as_tensor(rois_valid, device=device).bool()
            image = _image_from_u8(image[None], im_info[None],
                                   pixel_means)[0]
        with trace.span("predict.trunk_rpn"):
            feat = model.features_and_rpn(image)[0]
        with trace.span("predict.head"):
            cls_score, bbox_deltas, fc2 = model.head(feat, rois, rois.shape[0])
        out = {"rois": rois, "cls_score": cls_score, "bbox_pred": bbox_deltas,
               "fc2": fc2}
        with trace.span("predict.tail"):
            if learn_nms:
                out.update(base.learned_tail(cls_score, bbox_deltas, rois, fc2,
                                             im_info, class_thresh=0.0))
            else:
                out.update(base.classic_tail(cls_score, bbox_deltas, rois,
                                             rois_valid, im_info))
        return out

    return predict
