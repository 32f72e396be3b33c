"""The alternate (cached-proposal) workflow (port of
relation_tpu/core/rpn_workflow.py): train the RPN alone, dump its proposals
to a pickle, measure their recall, merge them into the roidb, and train the
RCNN head on them. The FPN YAMLs train this way (TRAIN.END2END false) and
test from the proposal file (TEST.HAS_RPN false).

The host-side functions (recall, bbox-target statistics, the proposal
roidb) are NumPy copies of the JAX package's, and give the same numbers.
The proposal pickle is the same file: a list of float32 [N, 5] arrays
(x1, y1, x2, y2, score) in original-image coordinates, one an image, so
each package reads the other's.

The two train steps keep the call contract of core/trainer.py::
make_train_step (``train_step(state, batch, priorities=None)``, in place,
on the card unless ``device="cpu"``) and the JAX semantics of the RCNN
step where it differs from the end-to-end step: ``sample_rois`` gets the
batch's ``rois_valid`` and always normalises its targets (with the given
means and stds, else TRAIN.BBOX_MEANS/STDS); the relation modules' keys
are the first min(TRAIN.RPN_POST_NMS_TOP_N, max_rois) ROIs; there is no RPN
loss; ``train_shared`` freezes network.FIXED_PARAMS_SHARED. Random
priorities: the RCNN step's "sample" vectors and the RPN step's "anchor"
vectors, each straight from the image's key in the JAX package.
"""

from __future__ import annotations

import os
import pickle
from typing import Callable

import numpy as np
import torch

from relation_tpu_torch.utils.native import bbox_overlaps


def generate_rpn_proposals(model, cfg, roidb, out_path: str, loader=None,
                           device="cuda") -> str:
    """RPN-only inference over ``loader`` (any iterable of ``(image_id,
    image, im_info)``, image NHWC [H, W, 3] or s2d [12, H/2, W/2], f32 or
    uint8 before mean subtraction; by default data/loader.py::TestLoader
    over ``roidb``) with the TEST.PROPOSAL_* settings; dumps each image's
    real proposals, divided by ``im_info[2]``, with their scores as float32
    [N, 5] to the pickle ``out_path``, in the loader's order. C4: softmax,
    then models/rpn.py::generate_proposals; FPN: generate_proposals_fpn (the
    exact top-k, whatever TPU.FPN_TOPK says). Returns ``out_path``."""
    from relation_tpu_torch.core.predictor import _image_from_u8
    from relation_tpu_torch.core.trainer import resolve_device
    from relation_tpu_torch.models.fpn import (FPN_STRIDES, RelationRCNNFPN,
                                               generate_proposals_fpn)
    from relation_tpu_torch.models.rpn import generate_proposals
    from relation_tpu_torch.ops.anchors import generate_anchors

    if loader is None:
        from relation_tpu_torch.data.loader import TestLoader
        loader = TestLoader(roidb, cfg)
    dev = next(model.parameters()).device
    if dev.type != resolve_device(device).type:
        raise ValueError(f"generate_rpn_proposals(device={str(device)!r}) for "
                         f"a model on {dev}")
    is_fpn = isinstance(model, RelationRCNNFPN)
    stride = int(cfg.network.RPN_FEAT_STRIDE)
    ratios = tuple(cfg.network.ANCHOR_RATIOS)
    scales = tuple(cfg.network.ANCHOR_SCALES)
    if is_fpn:
        base = {s: torch.as_tensor(generate_anchors(s, ratios, scales),
                                   dtype=torch.float32, device=dev)
                for s in FPN_STRIDES}
    else:
        base = torch.as_tensor(generate_anchors(stride, ratios, scales),
                               dtype=torch.float32, device=dev)
    top = (int(cfg.TEST.PROPOSAL_PRE_NMS_TOP_N),
           int(cfg.TEST.PROPOSAL_POST_NMS_TOP_N),
           float(cfg.TEST.PROPOSAL_NMS_THRESH), float(cfg.TEST.PROPOSAL_MIN_SIZE))
    pixel_means = tuple(float(m) for m in cfg.network.PIXEL_MEANS)

    boxes_per_image = []
    with torch.inference_mode():
        for _, image, im_info in loader:
            info = torch.as_tensor(np.asarray(im_info), dtype=torch.float32,
                                   device=dev)
            image = _image_from_u8(torch.as_tensor(image, device=dev), info,
                                   pixel_means)
            if is_fpn:
                _, rpn_out = model.features_and_rpn(image)
                rois, scores, real = generate_proposals_fpn(rpn_out, base, info,
                                                            *top)
            else:
                _, rpn_cls, rpn_bbox = model.features_and_rpn(image)
                rois, scores, real = generate_proposals(
                    torch.softmax(rpn_cls, dim=-1)[..., 1], rpn_bbox, base,
                    info, stride, *top)
            real = real.cpu().numpy()
            rois = rois.cpu().numpy() / float(np.asarray(im_info)[2])
            scores = scores.cpu().numpy()
            boxes_per_image.append(
                np.concatenate([rois[real], scores[real, None]], axis=1))

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "wb") as f:
        pickle.dump(boxes_per_image, f)
    return out_path


# proposal-recall area breakdown (reference imdb.py:287-289)
RECALL_AREA_RANGES = {
    "all": (0.0, 1e5 ** 2), "0-25": (0.0, 25.0 ** 2),
    "25-50": (25.0 ** 2, 50.0 ** 2), "50-100": (50.0 ** 2, 100.0 ** 2),
    "100-200": (100.0 ** 2, 200.0 ** 2), "200-300": (200.0 ** 2, 300.0 ** 2),
    "300-inf": (300.0 ** 2, 1e5 ** 2),
}


def _greedy_gt_coverage(ov: np.ndarray) -> np.ndarray:
    """One-to-one greedy proposal<->gt matching (imdb.py:339-357): repeatedly
    take the best-covered gt, record its IoU, retire both sides. Returns the
    recorded IoU per matched round, padded with zeros to n_gt."""
    ov = ov.copy()
    n_box, n_gt = ov.shape
    out = np.zeros(n_gt)
    for j in range(min(n_box, n_gt)):
        box_per_gt = ov.argmax(axis=0)
        best_per_gt = ov.max(axis=0)
        gt_ind = best_per_gt.argmax()
        out[j] = best_per_gt[gt_ind]
        ov[box_per_gt[gt_ind], :] = -1
        ov[:, gt_ind] = -1
    return out


def evaluate_recall(roidb, candidate_boxes, thresholds=None) -> dict:
    """Proposal recall (reference imdb.evaluate_recall, imdb.py:274-379):
    per area range, one-to-one greedy matching of proposals to gt, recall at
    each IoU threshold and the average recall; and the proposal-size
    histogram.

    Returns {'areas': {name: {recalls, thresholds, ar, num_pos}},
    'proposal_area_pct': {name: fraction}, 'ar', 'recalls', 'thresholds',
    'num_gt'}, the last four of the 'all' range."""
    thresholds = np.asarray(thresholds if thresholds is not None
                            else np.arange(0.5, 0.95 + 1e-5, 0.05))

    def areas_of(b):
        return (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)

    area_counts = {}
    for name, (lo, hi) in RECALL_AREA_RANGES.items():
        if name == "all":
            continue
        c = 0
        for boxes in candidate_boxes:
            if len(boxes):
                a = areas_of(boxes[:, :4])
                c += int(((a >= lo) & (a < hi)).sum())
        area_counts[name] = c
    total = float(max(sum(area_counts.values()), 1))

    out_areas = {}
    for name, (lo, hi) in RECALL_AREA_RANGES.items():
        gt_overlaps = []
        num_pos = 0
        for entry, boxes in zip(roidb, candidate_boxes):
            gt = entry["boxes"]
            keep = ~entry.get("iscrowd", np.zeros(len(gt), bool))
            gt = gt[keep & (entry["gt_classes"][:len(keep)] > 0)
                    if "gt_classes" in entry else keep]
            if len(gt):
                ga = areas_of(gt)
                gt = gt[(ga >= lo) & (ga < hi)]
            num_pos += len(gt)
            if len(gt) == 0 or len(boxes) == 0:
                continue
            ov = bbox_overlaps(boxes[:, :4].astype(np.float32),
                               gt.astype(np.float32))
            gt_overlaps.append(_greedy_gt_coverage(ov))
        cov = np.concatenate(gt_overlaps) if gt_overlaps else np.zeros(0)
        recalls = (np.asarray([(cov >= t).sum() / float(num_pos)
                               for t in thresholds])
                   if num_pos else np.zeros_like(thresholds))
        out_areas[name] = {"recalls": recalls, "thresholds": thresholds,
                           "ar": float(recalls.mean()), "num_pos": num_pos}

    allr = out_areas["all"]
    return {"areas": out_areas, "ar": allr["ar"], "recalls": allr["recalls"],
            "thresholds": thresholds, "num_gt": allr["num_pos"],
            "proposal_area_pct": {k: v / total for k, v in area_counts.items()}}


def _np_bbox_transform(ex: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Reference nonlinear_transform (lib/bbox/bbox_transform.py:55-75),
    +1 width convention."""
    ew = ex[:, 2] - ex[:, 0] + 1.0
    eh = ex[:, 3] - ex[:, 1] + 1.0
    ecx = ex[:, 0] + 0.5 * (ew - 1.0)
    ecy = ex[:, 1] + 0.5 * (eh - 1.0)
    gw = gt[:, 2] - gt[:, 0] + 1.0
    gh = gt[:, 3] - gt[:, 1] + 1.0
    gcx = gt[:, 0] + 0.5 * (gw - 1.0)
    gcy = gt[:, 1] + 0.5 * (gh - 1.0)
    return np.stack([(gcx - ecx) / (ew + 1e-14), (gcy - ecy) / (eh + 1e-14),
                     np.log(gw / ew), np.log(gh / eh)], axis=1)


def add_bbox_regression_stats(roidb, num_classes: int, class_agnostic: bool,
                              regression_thresh: float = 0.5):
    """Dataset-computed bbox-target means and stds (reference
    lib/bbox/bbox_regression.py:24-117, when BBOX_NORMALIZATION_PRECOMPUTED
    is false): per image the candidates are the gt boxes and the cached
    proposals; the targets of candidates with max gt overlap >=
    ``regression_thresh`` against their argmax gt are accumulated per class
    (class 1 collects everything when class-agnostic).

    Returns (means [K, 4], stds [K, 4]), K = 2 if class_agnostic else
    num_classes; row 0 (background) stays zero. For the agnostic configs
    pass ``means[1], stds[1]`` to the RCNN step."""
    K = 2 if class_agnostic else num_classes
    counts = np.zeros((K, 1)) + 1e-14
    sums = np.zeros((K, 4))
    sq = np.zeros((K, 4))
    for entry in roidb:
        gt = np.asarray(entry["boxes"], np.float32)
        keep = ~entry.get("iscrowd", np.zeros(len(gt), bool))
        gt = gt[keep]
        classes = np.asarray(entry["gt_classes"])[keep] \
            if "gt_classes" in entry else np.ones(len(gt), np.int64)
        if len(gt) == 0:
            continue
        props = np.asarray(entry.get("proposals", np.zeros((0, 4))), np.float32)
        rois = np.concatenate([gt, props], axis=0)
        ov = bbox_overlaps(rois, gt)
        max_ov = ov.max(axis=1)
        assign = ov.argmax(axis=1)
        ex = max_ov >= regression_thresh
        if not ex.any():
            continue
        tgts = _np_bbox_transform(rois[ex], gt[assign[ex]])
        labels = classes[assign[ex]]
        for cls in range(1, K):
            t = tgts if class_agnostic else tgts[labels == cls]
            if len(t) == 0:
                continue
            counts[cls] += len(t)
            sums[cls] += t.sum(axis=0)
            sq[cls] += (t ** 2).sum(axis=0)
    means = sums / counts
    stds = np.sqrt(np.maximum(sq / counts - means ** 2, 0.0))
    return means, stds


def load_proposal_roidb(roidb, proposal_file: str, top_rois: int = -1) -> list:
    """Attach cached proposals to a gt roidb (reference load_proposal_roidb,
    load_data.py:24 + imdb.rpn_roidb): each entry gains 'proposals' [N, 4],
    the ``top_rois`` highest-scoring ones when ``top_rois`` > 0."""
    with open(proposal_file, "rb") as f:
        boxes_per_image = pickle.load(f)
    if len(boxes_per_image) != len(roidb):
        raise ValueError(f"{len(boxes_per_image)} proposal sets != "
                         f"{len(roidb)} images")
    out = []
    for entry, props in zip(roidb, boxes_per_image):
        e = dict(entry)
        if top_rois > 0:
            order = np.argsort(-props[:, 4])[:top_rois]
            props = props[order]
        e["proposals"] = props[:, :4].astype(np.float32)
        out.append(e)
    return out


STOP_AFTER_RCNN = ("trunk", "sample", "pool", "head")


def make_train_step_rcnn(model, cfg, max_rois: int, max_gt: int,
                         bbox_means=None, bbox_stds=None,
                         train_shared: bool = False, fixed_prefixes=None,
                         no_grad: bool = False, stop_after: str = "",
                         device="cuda") -> Callable:
    """The RCNN-only step on cached proposals (reference
    function/train_rcnn.py): ``sample_rois`` over the batch's ROIs, then the
    head, OHEM, the RCNN losses and, with TRAIN.LEARN_NMS, the learned-NMS
    branch (core/trainer.py::head_losses_fn, the end-to-end step's code);
    no RPN loss.

    batch: dict(image, im_info, gt_boxes, gt_valid as in make_train_step,
    rois [B, R, 4] in the image's coordinates, rois_valid [B, R]); R <=
    ``max_rois``. ``priorities``: one dict an image, {"sample": (fg, bg,
    pad, gap) each [R + G]} when TRAIN.BATCH_ROIS >= 0 (the JAX step draws
    them from the image's key), else {} or None; None draws from
    ``state.generator``.

    ``train_shared`` takes network.FIXED_PARAMS_SHARED as the frozen set
    (reference function/train_rcnn.py:119-123), ``fixed_prefixes`` any
    other; the state's optimizer mask should match
    (core/trainer.py::refreeze_state). ``bbox_means`` / ``bbox_stds`` (4
    each) replace TRAIN.BBOX_MEANS/STDS, for statistics from
    ``add_bbox_regression_stats``. ``max_gt`` is accepted for the JAX
    signature.

    ``stop_after`` is one of the JAX step's benchmarking cuts
    (STOP_AFTER_RCNN, tools/train_cuts.py): the image's graph stops after
    'trunk' (1e-30 x the sum of its feature maps), 'sample' (1e-30 x the
    sampled rois, bbox targets and labels), 'pool' (1e-30 x the pooled ROI
    features) or 'head' (the RCNN losses without the learned-NMS branch),
    and the step trains on that loss, with total_loss its only metric but
    after 'head'; "" is the full step. The sampler draws as in the full
    step up to the cut."""
    from relation_tpu_torch.core.trainer import (head_losses_fn, run_step,
                                                 step_device, target_constants,
                                                 trainable_mask)
    from relation_tpu_torch.models.targets import sample_rois

    if stop_after and stop_after not in STOP_AFTER_RCNN:
        raise ValueError(f"stop_after={stop_after!r}: one of {STOP_AFTER_RCNN}")
    device = step_device(model, cfg, device, "make_train_step_rcnn")
    batch_rois = int(cfg.TRAIN.BATCH_ROIS)
    if bool(cfg.TRAIN.LEARN_NMS) and batch_rois >= 0:
        raise ValueError("LEARN_NMS requires take-all ROI mode (BATCH_ROIS=-1), "
                         "as in the reference configs")
    num_reg = 2 if cfg.CLASS_AGNOSTIC else int(cfg.dataset.NUM_CLASSES)
    nongt_dim = min(int(cfg.TRAIN.RPN_POST_NMS_TOP_N), int(max_rois))
    targets = target_constants(
        cfg.TRAIN.BBOX_MEANS if bbox_means is None else bbox_means,
        cfg.TRAIN.BBOX_STDS if bbox_stds is None else bbox_stds,
        cfg.TRAIN.BBOX_WEIGHTS, device)
    if fixed_prefixes is None:
        fixed_prefixes = (cfg.network.FIXED_PARAMS_SHARED if train_shared
                          else cfg.network.FIXED_PARAMS)
    step_mask = trainable_mask(model, tuple(fixed_prefixes))
    head_losses = head_losses_fn(model, cfg, stop_after=stop_after)

    def per_image(feat, _rpn, ins, generator, prio):
        if stop_after == "trunk":
            # the image's feature maps (every level of an FPN), no head
            levels = feat.values() if isinstance(feat, dict) else (feat,)
            total = 1e-30 * sum(torch.sum(f.float()) for f in levels)
            return total, {"total_loss": total}
        with torch.no_grad():
            tgt = sample_rois(
                ins["rois"], ins["rois_valid"], ins["gt_boxes"], ins["gt_valid"],
                generator, batch_rois=batch_rois, num_reg_classes=num_reg,
                fg_fraction=float(cfg.TRAIN.FG_FRACTION),
                fg_thresh=float(cfg.TRAIN.FG_THRESH),
                bg_thresh_hi=float(cfg.TRAIN.BG_THRESH_HI),
                bg_thresh_lo=float(cfg.TRAIN.BG_THRESH_LO),
                bbox_normalize=True, **targets,
                priorities=None if prio is None else prio.get("sample"))
        if stop_after == "sample":
            total = 1e-30 * (torch.sum(tgt["rois"]) + torch.sum(tgt["bbox_target"])
                             + torch.sum(tgt["label"].float()))
            return total, {"total_loss": total}
        if stop_after == "pool":
            flat = model.head(feat, tgt["rois"], nongt_dim, pool_only=True)
            total = 1e-30 * torch.sum(flat)
            return total, {"total_loss": total}
        parts, metrics = head_losses(feat, tgt, nongt_dim, ins["im_info"],
                                     ins["gt_boxes"], ins["gt_valid"])
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        metrics["total_loss"] = total
        return total, metrics

    def train_step(state, batch, priorities=None):
        if batch["rois"].shape[1] > max_rois:
            raise ValueError(f"{batch['rois'].shape[1]} rois an image, "
                             f"max_rois {max_rois}")
        return run_step(model, state, batch, priorities, per_image,
                        step_mask=step_mask, no_grad=no_grad, device=device,
                        pixel_means=cfg.network.PIXEL_MEANS,
                        reaches_params=stop_after != "sample")

    return train_step


def make_train_step_rpn(model, cfg, max_gt: int, device="cuda") -> Callable:
    """The RPN-only step (reference function/train_rpn.py): anchor targets
    and the RPN losses (valid-normalised cross entropy, smooth-L1 boxes) of
    the batched trunk and RPN; an FPN's five levels concatenated in
    FPN_STRIDES order, as in the end-to-end step. The frozen set is
    network.FIXED_PARAMS. Batch as in make_train_step; ``priorities``: one
    dict an image, {"anchor": (fg [K], bg [K])} (the JAX step draws them
    from the image's key), or None to draw from ``state.generator``.
    ``max_gt`` is accepted for the JAX signature.

    Differs from the JAX step under TPU.GRAD_CLIP: the JAX RPN step
    differentiates the frozen leaves too, so their gradients enter its
    global norm; here, as in every step of the port, only trainable leaves
    take a gradient."""
    from relation_tpu_torch.core.trainer import (rpn_loss_fn, rpn_rows_fn,
                                                 run_step, step_device,
                                                 trainable_mask)
    device = step_device(model, cfg, device, "make_train_step_rpn")
    step_mask = trainable_mask(model, tuple(cfg.network.FIXED_PARAMS))
    rpn_rows = rpn_rows_fn(model, cfg, device)
    rpn_loss = rpn_loss_fn(cfg, device)

    def per_image(_feat, rpn, ins, generator, prio):
        anchors, rpn_cls, rpn_bbox = rpn_rows(rpn)
        cls_loss, bbox_loss, acc = rpn_loss(
            anchors, rpn_cls, rpn_bbox, ins["im_info"], ins["gt_boxes"],
            ins["gt_valid"], generator, None if prio is None else prio["anchor"])
        total = cls_loss + bbox_loss
        return total, {"rpn_cls_loss": cls_loss, "rpn_bbox_loss": bbox_loss,
                       "rpn_acc": acc, "total_loss": total}

    def train_step(state, batch, priorities=None):
        return run_step(model, state, batch, priorities, per_image,
                        step_mask=step_mask, no_grad=False, device=device,
                        pixel_means=cfg.network.PIXEL_MEANS)

    return train_step
