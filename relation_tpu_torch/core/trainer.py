"""Model factory and the train step (port of relation_tpu/core/trainer.py).

``build_model`` is the registry of the C4 symbols, plain and DCN, and of the
FPN symbols. ``create_train_state`` and ``make_train_step`` mirror the JAX
entry points: one step is backbone (+deformable res5, or the FPN pyramid)
-> RPN -> anchor targets -> proposals -> ROI targets -> head (+relation) ->
losses (+OHEM, +learned NMS) -> gradients -> SGD with momentum, on the card
unless the caller asks for the CPU. Differences that PyTorch brings:

- parameters live in the model and are updated in place; the state holds the
  momentum buffers, the step count and the random generator;
- frozen parameters (network.FIXED_PARAMS prefixes, and always the
  BatchNorm vectors) get ``requires_grad=False``, the counterpart of the JAX
  step's stop_gradient: no gradient is computed for them and a clip norm
  sees trainable gradients only;
- random priorities come from a ``torch.Generator`` used in sequence, or are
  handed to the step (``priorities=``), as the parity tests do;
- the ``stop_after`` benchmarking cuts are not ported, and TPU.LNMS_REMAT is
  accepted and ignored (PyTorch keeps the activations).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from relation_tpu_torch.models.backbone import Conv2d
from relation_tpu_torch.models.detector import RelationRCNN
from relation_tpu_torch.models.fpn import (FPN_STRIDES, RelationRCNNFPN,
                                           fpn_anchors, generate_proposals_fpn)
from relation_tpu_torch.models.losses import (accuracy_ignore, learn_nms_losses,
                                              nms_accuracy, rcnn_losses,
                                              rpn_losses)
from relation_tpu_torch.models.rpn import generate_proposals
from relation_tpu_torch.models.targets import (anchor_targets, nms_multi_target,
                                               ohem_select, sample_rois)
from relation_tpu_torch.ops.anchors import generate_anchors, shift_anchors
from relation_tpu_torch.utils.lr import warmup_multi_factor_schedule

_ALWAYS_FROZEN = ("gamma", "beta", "moving_mean", "moving_var")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. Asking for CUDA where there is
    none is an error, never a quiet move to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run on the CPU")
    return device


def _dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if str(name) == "bfloat16" else torch.float32


def _freeze_through(fixed_prefixes) -> int:
    """Deepest trunk stage s such that conv1 and res2..res_s are all covered
    by FIXED_PARAMS prefixes (a parameter is frozen iff its name starts with
    a prefix, so 'res' covers every stage and 'res2' stage 2 only). Drives
    the no-gradient boundary of ResNet101C4."""
    def covered(name):
        return any(name.startswith(p) for p in fixed_prefixes)
    if not covered("conv1"):
        return 0
    return max((s for s in (2, 3, 4)
                if all(covered(f"res{t}") for t in range(2, s + 1))),
               default=0)


def build_model(cfg, tiny: bool = False,
                device="cuda") -> RelationRCNN | RelationRCNNFPN:
    """Instantiate the detector from a reference-schema config, on ``device``
    (``"meta"`` gives shapes without memory). Parameters are uninitialised:
    load them with ``load_state_dict`` (convert.py). Dtype policy of the JAX
    package: every parameter is f32; the conv trunk computes in
    TPU.COMPUTE_DTYPE (bf16 by default), the head in TPU.HEAD_DTYPE,
    everything in f32 for tiny models.

    The C4 symbols (plain 2FC head or relation head, with or without
    learned NMS), their DCN siblings (deformable res5 and deformable PSROI
    head, pooled in TPU.DCN_POOL_DTYPE) and the FPN symbols
    (RelationRCNNFPN; TPU.FPN_ALLOW_PALLAS True or "lnms" gives its
    learned-NMS head the C4 attention branch, False the two-stage one, and
    TPU.NMS_COMPACT_CLASSES caps the class skipping of the latter)."""
    sym = cfg.symbol
    threshes = np.fromstring(cfg.network.NMS_TARGET_THRESH, dtype=float, sep=",")
    precomputed = bool(cfg.TRAIN.BBOX_NORMALIZATION_PRECOMPUTED)
    conv_dtype = torch.float32 if tiny else _dtype(
        cfg.TPU.get("COMPUTE_DTYPE", "bfloat16"))
    head_dtype = torch.float32 if tiny else _dtype(
        cfg.TPU.get("HEAD_DTYPE", "bfloat16"))
    device = torch.device(device)
    if device.type != "meta":
        device = resolve_device(device)
    common = dict(
        num_classes=int(cfg.dataset.NUM_CLASSES),
        num_anchors=int(cfg.network.NUM_ANCHORS),
        class_agnostic=bool(cfg.CLASS_AGNOSTIC),
        use_relation=any(t in sym for t in ("rcnn_attention", "dcn_attention",
                                            "fpn_attention")),
        use_learn_nms=bool(cfg.TRAIN.LEARN_NMS or cfg.TEST.LEARN_NMS),
        first_n=int(cfg.TRAIN.FIRST_N),
        num_thresh=len(threshes),
        bbox_means=tuple(cfg.TRAIN.BBOX_MEANS) if precomputed else None,
        bbox_stds=tuple(cfg.TRAIN.BBOX_STDS) if precomputed else None,
        backbone="tiny" if tiny else "resnet101",
        head_dim=64 if tiny else 1024,
        conv_dtype=conv_dtype, head_dtype=head_dtype,
        freeze_through=_freeze_through(tuple(cfg.network.FIXED_PARAMS)))
    with torch.device(device):
        if "fpn" in sym:
            ap = cfg.TPU.get("FPN_ALLOW_PALLAS", False)
            model = RelationRCNNFPN(
                lnms_allow_pallas=(ap is True or ap == "lnms"),
                compact_classes=int(cfg.TPU.get("NMS_COMPACT_CLASSES", 32)),
                **common)
        else:
            model = RelationRCNN(
                rcnn_feat_stride=int(cfg.network.RCNN_FEAT_STRIDE),
                dcn="dcn" in sym,
                dcn_pool_dtype=torch.float32 if tiny else _dtype(
                    cfg.TPU.get("DCN_POOL_DTYPE", "bfloat16")),
                # "pallas" (default: the skip kernel when at most half the
                # classes are active) | "xla" (the dense or compact branch)
                lnms_allow_pallas=str(cfg.TPU.get("LNMS_ATTN", "pallas")) != "xla",
                compact_classes=int(cfg.TPU.get("NMS_COMPACT_CLASSES", 32)),
                **common)
    if str(cfg.TPU.get("ROI_METHOD", "align")) != "align":
        raise NotImplementedError("TPU.ROI_METHOD='pool' (exact ROIPooling) "
                                  "is not ported yet")
    # f32 master weights, cast to the compute dtype at the call, as the flax
    # convs do (param_dtype=float32): an SGD update at lr 5e-4 is below the
    # resolution of a bf16 weight
    for m in model.modules():
        if isinstance(m, Conv2d):
            m.compute_dtype = conv_dtype
    return model.eval()


def trainable_mask(names, fixed_prefixes) -> dict:
    """{name: True where trainable} for the '.'-joined names of a model's
    state_dict (or the model itself). A leaf is frozen if any component of
    its name starts with a FIXED_PARAMS prefix; the BatchNorm vectors
    (gamma, beta, moving_*) are always frozen."""
    if isinstance(names, torch.nn.Module):
        names = names.state_dict().keys()
    prefixes = tuple(fixed_prefixes) + _ALWAYS_FROZEN
    return {name: not any(comp.startswith(p) for comp in name.split(".")
                          for p in prefixes)
            for name in names}


@dataclasses.dataclass
class Optimizer:
    """The optax chain of the JAX trainer: optional global-norm clip, weight
    decay added to the gradient of trainable leaves, SGD with momentum
    (trace = g + m * trace, update = -lr(step) * trace), x0.01 on the
    ``offset`` leaves, nothing on frozen leaves."""
    schedule: Callable[[int], float]
    momentum: float
    wd: float
    clip: float
    mask: dict

    def init(self, model: torch.nn.Module) -> dict:
        """Zero momentum buffers for the trainable parameters."""
        return {n: torch.zeros_like(p) for n, p in model.named_parameters()
                if self.mask[n]}

    @torch.no_grad()
    def update(self, model: torch.nn.Module, trace: dict, step: int) -> None:
        """One in-place update of the trainable parameters from their
        ``.grad`` (a missing gradient counts as zero, so weight decay still
        moves the leaf, as in the JAX package)."""
        names, params, grads = [], [], []
        for n, p in model.named_parameters():
            if self.mask[n]:
                names.append(n)
                params.append(p)
                grads.append(torch.zeros_like(p) if p.grad is None else p.grad)
        if not params:
            return
        if self.clip > 0:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            # optax.clip_by_global_norm: scaled only above the limit
            scale = torch.where(norm < self.clip, torch.ones_like(norm),
                                self.clip / norm)
            grads = torch._foreach_mul(grads, scale)
        if self.wd:
            grads = torch._foreach_add(grads, params, alpha=self.wd)
        traces = [trace[n] for n in names]
        torch._foreach_mul_(traces, self.momentum)
        torch._foreach_add_(traces, grads)
        lr = self.schedule(step)
        slow = [i for i, n in enumerate(names) if "offset" in n.split(".")]
        if slow:
            for i, (p, t) in enumerate(zip(params, traces)):
                p.add_(t, alpha=-lr * (0.01 if i in slow else 1.0))
        else:
            torch._foreach_add_(params, traces, alpha=-lr)


def make_optimizer(cfg, epoch_size: int, mask: dict) -> Optimizer:
    steps = [int(float(s) * epoch_size)
             for s in str(cfg.TRAIN.lr_step).split(",") if s.strip()]
    sched = warmup_multi_factor_schedule(
        float(cfg.TRAIN.lr), steps, float(cfg.TRAIN.lr_factor),
        bool(cfg.TRAIN.warmup), float(cfg.TRAIN.warmup_lr),
        int(cfg.TRAIN.warmup_step))
    return Optimizer(schedule=sched, momentum=float(cfg.TRAIN.momentum),
                     wd=float(cfg.TRAIN.wd),
                     clip=float(cfg.TPU.get("GRAD_CLIP", 0.0)), mask=mask)


@dataclasses.dataclass
class TrainState:
    """What a train step carries besides the model's own parameters."""
    step: int
    model: RelationRCNN
    trace: dict                      # momentum buffers of the trainable leaves
    generator: torch.Generator
    tx: Optimizer


def _set_requires_grad(model, mask) -> None:
    for n, p in model.named_parameters():
        p.requires_grad_(bool(mask[n]))


def create_train_state(model: RelationRCNN, cfg, seed: int = 0,
                       epoch_size: int = 1000, fixed_prefixes=None) -> TrainState:
    """Optimizer state over the parameters the model holds now (load or
    initialise them first). ``fixed_prefixes`` overrides
    cfg.network.FIXED_PARAMS for the freeze mask. ``seed`` seeds the
    generator of the random priorities, on the model's device."""
    if fixed_prefixes is None:
        fixed_prefixes = cfg.network.FIXED_PARAMS
    mask = trainable_mask(model, fixed_prefixes)
    _set_requires_grad(model, mask)
    tx = make_optimizer(cfg, epoch_size, mask)
    gen = torch.Generator(device=next(model.parameters()).device)
    gen.manual_seed(int(seed))
    return TrainState(step=0, model=model, trace=tx.init(model), generator=gen,
                      tx=tx)


def refreeze_state(state: TrainState, cfg, fixed_prefixes,
                   epoch_size: int = 1000) -> TrainState:
    """A fresh optimizer over the same parameters with a new freeze mask (the
    per-stage re-init of the alternate workflow). Momentum restarts at zero."""
    mask = trainable_mask(state.model, fixed_prefixes)
    _set_requires_grad(state.model, mask)
    tx = make_optimizer(cfg, epoch_size, mask)
    return dataclasses.replace(state, trace=tx.init(state.model), tx=tx)


def make_train_step(model: RelationRCNN | RelationRCNNFPN, cfg,
                    stop_after: str = "", fixed_prefixes=None,
                    no_grad: bool = False, device="cuda") -> Callable:
    """Build the per-batch train step of a C4 symbol (plain or DCN) or of an
    FPN symbol, on ``device`` (the model must live there; asking for CUDA
    where there is none raises). The symbol and the model must agree: an
    FPN symbol takes a RelationRCNNFPN, a DCN symbol a model built with the
    DCN parts.

    Returns ``train_step(state, batch, priorities=None) -> (state, metrics)``.
    batch: dict(image [B, H, W, 3] or s2d [B, 12, H/2, W/2] (f32, or uint8
    before mean subtraction), im_info [B, 3], gt_boxes [B, G, 5],
    gt_valid [B, G]), numpy or tensors on any device. ``metrics`` are 0-dim
    tensors, the batch means. The parameters and the state are updated in
    place and the same state object is returned.

    The FPN step is the JAX package's FPN branch: the anchors of the five
    levels concatenated in FPN_STRIDES order and the raw RPN outputs
    flattened level by level in the same order (anchor targets, RPN
    losses); proposals from ``generate_proposals_fpn`` (every level decoded,
    one exact top-k, one NMS) on the RPN outputs without gradient; the
    pooled head on the image's slice of the batched pyramid.

    ``priorities``: one dict per image, ``{"anchor": (fg [K], bg [K]),
    "sample": (fg, bg, pad, gap) each [R + G]}``, the uniform vectors that
    rank the random subsampling (K: the anchors, of every level for an FPN;
    "sample" only when TRAIN.BATCH_ROIS >= 0); None draws them from
    ``state.generator``.

    ``fixed_prefixes`` overrides cfg.network.FIXED_PARAMS for the set of
    parameters that take no gradient. ``no_grad`` gives the forward-only step
    (metrics, parameters untouched). ``stop_after`` (the JAX package's
    benchmarking cuts) is not ported: anything but "" raises.
    """
    if stop_after:
        raise NotImplementedError(
            f"stop_after={stop_after!r}: the benchmarking cuts of the JAX "
            "train step are not ported")
    is_fpn = isinstance(model, RelationRCNNFPN)
    if ("fpn" in cfg.symbol) != is_fpn:
        raise ValueError(f"{cfg.symbol}: the model was built as "
                         f"{'an FPN' if is_fpn else 'a C4'} detector")
    if ("dcn" in cfg.symbol) != bool(getattr(model, "dcn", False)):
        raise ValueError(f"{cfg.symbol}: the model was built "
                         f"{'with' if model.dcn else 'without'} the DCN parts")
    device = resolve_device(device)
    model_dev = next(model.parameters()).device
    if model_dev.type != device.type:
        raise ValueError(f"make_train_step(device={str(device)!r}) for a model "
                         f"on {model_dev}")
    device = model_dev
    stride = int(cfg.network.RPN_FEAT_STRIDE)
    scales = tuple(cfg.network.ANCHOR_SCALES)
    ratios = tuple(cfg.network.ANCHOR_RATIOS)
    base_anchors = generate_anchors(stride, ratios, scales)
    base_anchors_t = torch.as_tensor(base_anchors, dtype=torch.float32,
                                     device=device)
    # an FPN level's base anchors: base size = the level's stride
    level_base = {s: torch.as_tensor(generate_anchors(s, ratios, scales),
                                     dtype=torch.float32, device=device)
                  for s in FPN_STRIDES} if is_fpn else None
    nongt_dim = int(cfg.TRAIN.RPN_POST_NMS_TOP_N)
    batch_rois = int(cfg.TRAIN.BATCH_ROIS)
    num_reg = 2 if cfg.CLASS_AGNOSTIC else int(cfg.dataset.NUM_CLASSES)
    threshes = tuple(np.fromstring(cfg.network.NMS_TARGET_THRESH, dtype=float,
                                   sep=","))
    ohem = bool(cfg.TRAIN.ENABLE_OHEM)
    learn_nms = bool(cfg.TRAIN.LEARN_NMS)
    if learn_nms and batch_rois >= 0:
        raise ValueError("LEARN_NMS requires take-all ROI mode (BATCH_ROIS=-1), "
                         "as in the reference configs")
    bbox_norm_denom = float(cfg.TRAIN.BATCH_ROIS_OHEM if ohem
                            else (300 if batch_rois < 0 else batch_rois))
    pixel_means = tuple(float(m) for m in cfg.network.PIXEL_MEANS)
    if fixed_prefixes is None:
        fixed_prefixes = tuple(cfg.network.FIXED_PARAMS)
    step_mask = trainable_mask(model, fixed_prefixes)
    anchor_grids = {}              # the shifted anchors, by feature shape(s)

    def rpn_rows(rpn):
        """(anchors [K, 4], rpn_cls [K, 2], rpn_bbox [K, 4]) of one image in
        (h, w, a) order; an FPN's levels concatenated in FPN_STRIDES order."""
        if is_fpn:
            shapes = tuple((s, tuple(rpn[s][0].shape[:2])) for s in FPN_STRIDES)
            if shapes not in anchor_grids:
                grids = fpn_anchors(dict(shapes), scales, ratios, device=device)
                anchor_grids[shapes] = torch.cat([grids[s] for s in FPN_STRIDES])
            # raw [h, w, 2A] / [h, w, 4A]: reshape(-1, 2 or 4) gives the
            # (h, w, a)-major rows of the C4 head's [h, w, A, 2 or 4]
            return (anchor_grids[shapes],
                    torch.cat([rpn[s][0].reshape(-1, 2) for s in FPN_STRIDES]),
                    torch.cat([rpn[s][1].reshape(-1, 4) for s in FPN_STRIDES]))
        rpn_cls, rpn_bbox = rpn
        fh, fw = rpn_cls.shape[0], rpn_cls.shape[1]
        if (fh, fw) not in anchor_grids:
            anchor_grids[fh, fw] = shift_anchors(base_anchors, fh, fw, stride,
                                                 device=device)
        return (anchor_grids[fh, fw], rpn_cls.reshape(-1, 2),
                rpn_bbox.reshape(-1, 4))

    def proposals(rpn, im_info):
        """The image's proposals [post_N, 4] (called without gradient)."""
        top = (int(cfg.TRAIN.RPN_PRE_NMS_TOP_N), int(cfg.TRAIN.RPN_POST_NMS_TOP_N),
               float(cfg.TRAIN.RPN_NMS_THRESH), float(cfg.TRAIN.RPN_MIN_SIZE))
        if is_fpn:
            return generate_proposals_fpn(rpn, level_base, im_info, *top)[0]
        rpn_cls, rpn_bbox = rpn
        return generate_proposals(torch.softmax(rpn_cls, dim=-1)[..., 1],
                                  rpn_bbox, base_anchors_t, im_info, stride,
                                  *top)[0]

    def per_image(feat, rpn, im_info, gt_boxes, gt_valid, generator, prio):
        """Everything after the batched conv trunk, for one image. C4: feat
        [h, w, 256], rpn (rpn_cls [h, w, A, 2], rpn_bbox [h, w, A, 4]); FPN:
        feat {stride: [h, w, 256]}, rpn {stride: (rpn_cls [h, w, 2A],
        rpn_bbox [h, w, 4A])}."""
        anchors, rpn_cls_flat, rpn_bbox_flat = rpn_rows(rpn)
        label, btgt, bwt = anchor_targets(
            anchors, gt_boxes, gt_valid, im_info, generator,
            rpn_batch_size=int(cfg.TRAIN.RPN_BATCH_SIZE),
            fg_fraction=float(cfg.TRAIN.RPN_FG_FRACTION),
            positive_overlap=float(cfg.TRAIN.RPN_POSITIVE_OVERLAP),
            negative_overlap=float(cfg.TRAIN.RPN_NEGATIVE_OVERLAP),
            clobber_positives=bool(cfg.TRAIN.RPN_CLOBBER_POSITIVES),
            bbox_weights=tuple(cfg.TRAIN.RPN_BBOX_WEIGHTS),
            priorities=None if prio is None else prio["anchor"])
        rpn_cls_loss, rpn_bbox_loss = rpn_losses(
            rpn_cls_flat, rpn_bbox_flat, label, btgt, bwt,
            int(cfg.TRAIN.RPN_BATCH_SIZE), sigma=float(cfg.TRAIN.rpn_loss_scale))

        with torch.no_grad():
            rois = proposals(rpn, im_info)
            tgt = sample_rois(
                rois, torch.ones(rois.shape[0], dtype=torch.bool, device=device),
                gt_boxes, gt_valid, generator,
                batch_rois=batch_rois, num_reg_classes=num_reg,
                fg_fraction=float(cfg.TRAIN.FG_FRACTION),
                fg_thresh=float(cfg.TRAIN.FG_THRESH),
                bg_thresh_hi=float(cfg.TRAIN.BG_THRESH_HI),
                bg_thresh_lo=float(cfg.TRAIN.BG_THRESH_LO),
                bbox_normalize=bool(cfg.TRAIN.BBOX_NORMALIZATION_PRECOMPUTED),
                bbox_means=tuple(cfg.TRAIN.BBOX_MEANS),
                bbox_stds=tuple(cfg.TRAIN.BBOX_STDS),
                bbox_weights=tuple(np.asarray(cfg.TRAIN.BBOX_WEIGHTS).tolist()),
                priorities=None if prio is None else prio.get("sample"))

        cls_score, bbox_pred, fc2 = model.head(feat, tgt["rois"], nongt_dim)
        rlabel, rweight = tgt["label"], tgt["bbox_weight"]
        if ohem:
            rlabel, rweight = ohem_select(cls_score, bbox_pred, rlabel,
                                          tgt["bbox_target"], rweight,
                                          int(cfg.TRAIN.BATCH_ROIS_OHEM))
        rcnn_cls_loss, rcnn_bbox_loss = rcnn_losses(
            cls_score, bbox_pred, rlabel, tgt["bbox_target"], rweight,
            bbox_norm_denom)
        total = rpn_cls_loss + rpn_bbox_loss + rcnn_cls_loss + rcnn_bbox_loss
        metrics = {
            "rpn_cls_loss": rpn_cls_loss, "rpn_bbox_loss": rpn_bbox_loss,
            "rcnn_cls_loss": rcnn_cls_loss, "rcnn_bbox_loss": rcnn_bbox_loss,
            "rpn_acc": accuracy_ignore(rpn_cls_flat, label),
            "rcnn_acc": accuracy_ignore(cls_score, rlabel),
        }
        if learn_nms:
            ln = model.learn_nms(cls_score[:nongt_dim], bbox_pred[:nongt_dim],
                                 tgt["rois"][:nongt_dim], fc2[:nongt_dim],
                                 im_info)
            nt = nms_multi_target(ln["sorted_bbox"], gt_boxes, gt_valid,
                                  ln["sorted_score"].detach(), threshes)
            nms_total, pos_l, neg_l = learn_nms_losses(
                ln["nms_multi_score"], nt, float(cfg.TRAIN.nms_loss_scale),
                float(cfg.TRAIN.nms_pos_scale))
            acc_pos, acc_neg = nms_accuracy(ln["nms_multi_score"], nt)
            total = total + nms_total
            metrics.update({"nms_pos_loss": pos_l, "nms_neg_loss": neg_l,
                            "nms_acc_pos": acc_pos, "nms_acc_neg": acc_neg})
        metrics["total_loss"] = total
        return total, metrics

    def train_step(state: TrainState, batch, priorities=None):
        from relation_tpu_torch.core.predictor import _image_from_u8
        if state.model is not model:
            raise ValueError("train_step: the state belongs to another model")
        image = torch.as_tensor(batch["image"], device=device)
        im_info = torch.as_tensor(batch["im_info"], dtype=torch.float32,
                                  device=device)
        gt_boxes = torch.as_tensor(batch["gt_boxes"], dtype=torch.float32,
                                   device=device)
        gt_valid = torch.as_tensor(batch["gt_valid"], device=device).bool()
        B = image.shape[0]
        if priorities is not None and len(priorities) != B:
            raise ValueError(f"priorities for {len(priorities)} images, "
                             f"batch of {B}")
        _set_requires_grad(model, step_mask)
        with torch.set_grad_enabled(not no_grad):
            if image.dtype == torch.uint8:
                image = torch.stack([_image_from_u8(image[b], im_info[b],
                                                    pixel_means)
                                     for b in range(B)])
            if is_fpn:
                pyramid, rpn_out = model.features_and_rpn(image)
                feats = [{s: f[b] for s, f in pyramid.items()} for b in range(B)]
                rpns = [{s: (c[b], r[b]) for s, (c, r) in rpn_out.items()}
                        for b in range(B)]
            else:
                feat, rpn_cls, rpn_bbox = model.features_and_rpn(image)
                feats, rpns = list(feat), list(zip(rpn_cls, rpn_bbox))
            totals, per = [], []
            for b in range(B):
                tot, m = per_image(
                    feats[b], rpns[b], im_info[b], gt_boxes[b], gt_valid[b],
                    state.generator,
                    None if priorities is None else priorities[b])
                totals.append(tot)
                per.append(m)
            loss = torch.stack(totals).mean()
            metrics = {k: torch.stack([m[k] for m in per]).mean().detach()
                       for k in per[0]}
            if not no_grad:
                for p in model.parameters():
                    p.grad = None
                loss.backward()
                state.tx.update(model, state.trace, state.step)
                for p in model.parameters():
                    p.grad = None
        state.step += 1
        return state, metrics

    return train_step
