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
- data parallelism (``make_train_step(..., mesh=)``, parallel/mesh.py) is
  one process a rank: each rank's loss is the mean over its images, and
  the gradients of the trainable leaves and the metrics are averaged over
  the ranks before the clip and the update, so every rank applies the same
  update (the reference's kvstore 'device' sum with rescale_grad, which
  the JAX step gets from XLA's all-reduce). Every rank draws the global
  batch's priorities from its copy of the generator, in the order a
  one-process step draws them, and keeps its images' share, so the
  generators stay in step;
- TPU.LNMS_REMAT recomputes the learned-NMS branch's forward in the
  backward (``torch.utils.checkpoint``), as the JAX step's
  ``jax.checkpoint`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.utils.checkpoint

from relation_tpu_torch.models.backbone import Conv2d
from relation_tpu_torch.models.detector import RelationRCNN
from relation_tpu_torch.models.fpn import (FPN_STRIDES, RelationRCNNFPN,
                                           fpn_anchors, generate_proposals_fpn)
from relation_tpu_torch.models.losses import (accuracy_ignore, learn_nms_losses,
                                              nms_accuracy, rcnn_losses,
                                              rpn_losses)
from relation_tpu_torch.models.rpn import generate_proposals
from relation_tpu_torch.models.targets import (anchor_targets, nms_multi_target,
                                               ohem_select, sample_rois,
                                               uniform_priorities)
from relation_tpu_torch.ops.anchors import generate_anchors, shift_anchors
from relation_tpu_torch.utils import trace
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


@trace.span("setup.model")
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
    TPU.NMS_COMPACT_CLASSES caps the class skipping of the latter).
    TPU.ROI_METHOD pools the ROIs of the C4 and FPN heads: "align"
    (ROIAlign, the default) or "pool" (exact MXNet ROIPooling, the parity
    mode of converted reference weights); the DCN head pools with its
    deformable PSROI pool either way."""
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
        freeze_through=_freeze_through(tuple(cfg.network.FIXED_PARAMS)),
        roi_method=str(cfg.TPU.get("ROI_METHOD", "align")))
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
    """What a train step carries besides the model's own parameters.
    ``count`` is the optimizer's own update count, the step of the schedule
    (optax's ScaleByScheduleState.count in the JAX package): it stays put in
    a ``no_grad`` step and restarts with the momentum in ``refreeze_state``,
    while ``step`` counts every call. ``seed`` is the generator's seed."""
    step: int
    model: RelationRCNN
    trace: dict                      # momentum buffers of the trainable leaves
    generator: torch.Generator
    tx: Optimizer
    count: int = 0
    seed: int = 0


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
                      tx=tx, seed=int(seed))


def refreeze_state(state: TrainState, cfg, fixed_prefixes,
                   epoch_size: int = 1000) -> TrainState:
    """A fresh optimizer over the same parameters with a new freeze mask (the
    per-stage re-init of the alternate workflow). Momentum and the
    schedule's count restart at zero, as a fresh optax chain's do."""
    mask = trainable_mask(state.model, fixed_prefixes)
    _set_requires_grad(state.model, mask)
    tx = make_optimizer(cfg, epoch_size, mask)
    return dataclasses.replace(state, trace=tx.init(state.model), tx=tx, count=0)


STOP_AFTER = ("rpn", "anchor_targets", "proposals", "sample", "feat", "pool",
              "head", "lnms_embed", "lnms_attn", "lnms_score", "lnms_target")
# the learned-NMS head's probe (LearnNMSHead.forward) of each cut inside it
LNMS_PROBES = {"lnms_embed": "embed", "lnms_attn": "attn"}


def make_train_step(model: RelationRCNN | RelationRCNNFPN, cfg,
                    stop_after: str = "", fixed_prefixes=None,
                    no_grad: bool = False, device="cuda",
                    mesh=None) -> Callable:
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

    ``priorities``: one dict per image of ``batch``, ``{"anchor": (fg [K],
    bg [K]), "sample": (fg, bg, pad, gap) each [R + G]}``, the uniform
    vectors that rank the random subsampling (K: the anchors, of every
    level for an FPN; "sample" only when TRAIN.BATCH_ROIS >= 0); None draws
    them from ``state.generator``.

    ``mesh`` (parallel/mesh.py::make_mesh; None or one rank: no
    collectives): ``batch`` is this rank's share of a global batch of
    ``world`` equal shares (shard_batch), the state is the same on every
    rank (``replicated``), and the step averages the trainable leaves'
    gradients and the metrics over the ranks before the update. Without
    ``priorities`` every rank draws the whole global batch's in the order of
    a one-process step and keeps its share.

    ``fixed_prefixes`` overrides cfg.network.FIXED_PARAMS for the set of
    parameters that take no gradient. ``no_grad`` gives the forward-only step
    (metrics, parameters untouched). ``stop_after`` is one of the JAX
    package's benchmarking cuts (STOP_AFTER, tools/train_cuts.py): the
    image's graph stops after that stage and the step trains on the partial
    loss, with the JAX cut's metrics ('rpn' to 'pool': total_loss only;
    'head': the head's losses without the learned-NMS branch; 'lnms_embed'
    / 'lnms_attn': the branch cut inside the head by its probe,
    'lnms_score' / 'lnms_target' after its scores or its targets, each with
    the branch's four metrics equal to its 1e-30 term); "" is the full
    step.
    """
    if stop_after and stop_after not in STOP_AFTER:
        raise ValueError(f"stop_after={stop_after!r}: one of {STOP_AFTER}")
    device = step_device(model, cfg, device, "make_train_step")
    is_fpn = isinstance(model, RelationRCNNFPN)
    stride = int(cfg.network.RPN_FEAT_STRIDE)
    ratios, scales = tuple(cfg.network.ANCHOR_RATIOS), tuple(cfg.network.ANCHOR_SCALES)
    base_anchors_t = torch.as_tensor(generate_anchors(stride, ratios, scales),
                                     dtype=torch.float32, device=device)
    # an FPN level's base anchors: base size = the level's stride
    level_base = {s: torch.as_tensor(generate_anchors(s, ratios, scales),
                                     dtype=torch.float32, device=device)
                  for s in FPN_STRIDES} if is_fpn else None
    nongt_dim = int(cfg.TRAIN.RPN_POST_NMS_TOP_N)
    batch_rois = int(cfg.TRAIN.BATCH_ROIS)
    num_reg = 2 if cfg.CLASS_AGNOSTIC else int(cfg.dataset.NUM_CLASSES)
    if bool(cfg.TRAIN.LEARN_NMS) and batch_rois >= 0:
        raise ValueError("LEARN_NMS requires take-all ROI mode (BATCH_ROIS=-1), "
                         "as in the reference configs")
    if fixed_prefixes is None:
        fixed_prefixes = tuple(cfg.network.FIXED_PARAMS)
    step_mask = trainable_mask(model, fixed_prefixes)
    rpn_rows = rpn_rows_fn(model, cfg, device)
    rpn_loss = rpn_loss_fn(cfg, device)
    head_losses = head_losses_fn(model, cfg, stop_after=stop_after)
    cut = STOP_AFTER.index(stop_after) if stop_after else len(STOP_AFTER)
    targets = target_constants(cfg.TRAIN.BBOX_MEANS, cfg.TRAIN.BBOX_STDS,
                               cfg.TRAIN.BBOX_WEIGHTS, device)

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

    def draw(rpn, n_images: int, n_gt: int, generator) -> list:
        """The priorities of ``n_images`` images in the order a step draws
        them image after image: the anchors' (fg, bg) unless the step stops
        at the RPN, then the sampler's four vectors in sampled mode."""
        out = []
        n_anchors = rpn_rows(rpn)[0].shape[0]
        for _ in range(n_images):
            prio = {}
            if cut > STOP_AFTER.index("rpn"):
                prio["anchor"] = uniform_priorities(generator, 2, n_anchors,
                                                    device)
            if cut > STOP_AFTER.index("proposals") and batch_rois >= 0:
                prio["sample"] = uniform_priorities(generator, 4,
                                                    nongt_dim + n_gt, device)
            out.append(prio)
        return out

    def per_image(feat, rpn, ins, generator, prio):
        """Everything after the batched conv trunk, for one image. C4: feat
        [h, w, 256], rpn (rpn_cls [h, w, A, 2], rpn_bbox [h, w, A, 4]); FPN:
        feat {stride: [h, w, 256]}, rpn {stride: (rpn_cls [h, w, 2A],
        rpn_bbox [h, w, 4A])}."""
        im_info, gt_boxes, gt_valid = ins["im_info"], ins["gt_boxes"], ins["gt_valid"]
        anchors, rpn_cls_flat, rpn_bbox_flat = rpn_rows(rpn)
        if stop_after == "rpn":
            # gradients still flow through the whole trunk and the RPN
            tot = (torch.mean(torch.square(rpn_cls_flat.float()))
                   + torch.mean(torch.square(rpn_bbox_flat.float())))
            return tot, {"total_loss": tot}
        rpn_cls_loss, rpn_bbox_loss, rpn_acc = rpn_loss(
            anchors, rpn_cls_flat, rpn_bbox_flat, im_info, gt_boxes, gt_valid,
            generator, None if prio is None else prio["anchor"])
        total = rpn_cls_loss + rpn_bbox_loss
        if stop_after == "anchor_targets":
            return total, {"total_loss": total}
        with torch.no_grad():
            rois = proposals(rpn, im_info)
        if stop_after == "proposals":
            # the proposals carry no gradient; the 1e-30 term keeps them in
            # the loss, as in the JAX cut
            total = total + 1e-30 * torch.sum(rois)
            return total, {"total_loss": total}
        with torch.no_grad():
            tgt = sample_rois(
                rois, torch.ones(rois.shape[0], dtype=torch.bool, device=device),
                gt_boxes, gt_valid, generator,
                batch_rois=batch_rois, num_reg_classes=num_reg,
                fg_fraction=float(cfg.TRAIN.FG_FRACTION),
                fg_thresh=float(cfg.TRAIN.FG_THRESH),
                bg_thresh_hi=float(cfg.TRAIN.BG_THRESH_HI),
                bg_thresh_lo=float(cfg.TRAIN.BG_THRESH_LO),
                bbox_normalize=bool(cfg.TRAIN.BBOX_NORMALIZATION_PRECOMPUTED),
                **targets,
                priorities=None if prio is None else prio.get("sample"))
        if stop_after == "sample":
            total = total + 1e-30 * (torch.sum(tgt["rois"])
                                     + torch.sum(tgt["bbox_target"])
                                     + torch.sum(tgt["label"].float()))
            return total, {"total_loss": total}
        if stop_after == "feat":
            # the head's feature map without pooling (every level of an FPN)
            levels = feat.values() if is_fpn else (feat,)
            total = total + 1e-30 * sum(torch.sum(f.float()) for f in levels)
            return total, {"total_loss": total}
        if stop_after == "pool":
            flat = model.head(feat, tgt["rois"], nongt_dim, pool_only=True)
            total = total + 1e-30 * torch.sum(flat)
            return total, {"total_loss": total}
        parts, metrics = head_losses(feat, tgt, nongt_dim, im_info, gt_boxes,
                                     gt_valid)
        for part in parts:
            total = total + part
        metrics.update({"rpn_cls_loss": rpn_cls_loss,
                        "rpn_bbox_loss": rpn_bbox_loss, "rpn_acc": rpn_acc,
                        "total_loss": total})
        return total, metrics

    def train_step(state: TrainState, batch, priorities=None):
        return run_step(model, state, batch, priorities, per_image,
                        step_mask=step_mask, no_grad=no_grad, device=device,
                        pixel_means=cfg.network.PIXEL_MEANS, mesh=mesh,
                        draw=draw)

    return train_step


# --------------------------------------------------------------------------
# the parts of a step that the end-to-end step and the alternate workflow's
# RPN and RCNN steps (core/rpn_workflow.py) share
# --------------------------------------------------------------------------

def step_device(model, cfg, device, what: str) -> torch.device:
    """The model's device, after checking that the symbol matches the model
    and that ``device`` is where the model lives (CUDA where there is none
    raises)."""
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
        raise ValueError(f"{what}(device={str(device)!r}) for a model "
                         f"on {model_dev}")
    return model_dev


def rpn_rows_fn(model, cfg, device) -> Callable:
    """rows(rpn) -> (anchors [K, 4], rpn_cls [K, 2], rpn_bbox [K, 4]) of one
    image in (h, w, a) order; an FPN's five levels concatenated in
    FPN_STRIDES order. The shifted anchors are kept by feature shape."""
    is_fpn = isinstance(model, RelationRCNNFPN)
    stride = int(cfg.network.RPN_FEAT_STRIDE)
    scales = tuple(cfg.network.ANCHOR_SCALES)
    ratios = tuple(cfg.network.ANCHOR_RATIOS)
    base_anchors = generate_anchors(stride, ratios, scales)
    grids = {}

    def rows(rpn):
        if is_fpn:
            shapes = tuple((s, tuple(rpn[s][0].shape[:2])) for s in FPN_STRIDES)
            if shapes not in grids:
                level = fpn_anchors(dict(shapes), scales, ratios, device=device)
                grids[shapes] = torch.cat([level[s] for s in FPN_STRIDES])
            # raw [h, w, 2A] / [h, w, 4A]: reshape(-1, 2 or 4) gives the
            # (h, w, a)-major rows of the C4 head's [h, w, A, 2 or 4]
            return (grids[shapes],
                    torch.cat([rpn[s][0].reshape(-1, 2) for s in FPN_STRIDES]),
                    torch.cat([rpn[s][1].reshape(-1, 4) for s in FPN_STRIDES]))
        rpn_cls, rpn_bbox = rpn
        fh, fw = rpn_cls.shape[0], rpn_cls.shape[1]
        if (fh, fw) not in grids:
            grids[fh, fw] = shift_anchors(base_anchors, fh, fw, stride,
                                          device=device)
        return grids[fh, fw], rpn_cls.reshape(-1, 2), rpn_bbox.reshape(-1, 4)
    return rows


def target_constants(means, stds, weights, device) -> dict:
    """``sample_rois``' bbox_means, bbox_stds and bbox_weights as f32
    tensors on ``device``, made once where a step is built: a tensor made
    from host values inside the step is a blocking copy to the card an
    image."""
    return {k: torch.tensor([float(x) for x in v], dtype=torch.float32,
                            device=device)
            for k, v in (("bbox_means", means), ("bbox_stds", stds),
                         ("bbox_weights", weights))}


def rpn_loss_fn(cfg, device) -> Callable:
    """loss(anchors, rpn_cls, rpn_bbox, im_info, gt_boxes, gt_valid,
    generator, priorities) -> (cls loss, bbox loss, accuracy): anchor
    targets (``priorities`` the (fg, bg) uniform vectors, or None to draw
    from ``generator``) and the RPN losses of one image on ``device``."""
    bbox_weights = torch.tensor(tuple(cfg.TRAIN.RPN_BBOX_WEIGHTS),
                                dtype=torch.float32, device=device)

    def loss(anchors, rpn_cls, rpn_bbox, im_info, gt_boxes, gt_valid,
             generator, priorities):
        label, btgt, bwt = anchor_targets(
            anchors, gt_boxes, gt_valid, im_info, generator,
            rpn_batch_size=int(cfg.TRAIN.RPN_BATCH_SIZE),
            fg_fraction=float(cfg.TRAIN.RPN_FG_FRACTION),
            positive_overlap=float(cfg.TRAIN.RPN_POSITIVE_OVERLAP),
            negative_overlap=float(cfg.TRAIN.RPN_NEGATIVE_OVERLAP),
            clobber_positives=bool(cfg.TRAIN.RPN_CLOBBER_POSITIVES),
            bbox_weights=bbox_weights, priorities=priorities)
        cls_loss, bbox_loss = rpn_losses(
            rpn_cls, rpn_bbox, label, btgt, bwt, int(cfg.TRAIN.RPN_BATCH_SIZE),
            sigma=float(cfg.TRAIN.rpn_loss_scale))
        return cls_loss, bbox_loss, accuracy_ignore(rpn_cls, label)
    return loss


def head_losses_fn(model, cfg, stop_after: str = "") -> Callable:
    """losses(feat, tgt, nongt_dim, im_info, gt_boxes, gt_valid) -> (parts,
    metrics): everything after ``sample_rois`` for one image, the head (its
    relation modules over the first ``nongt_dim`` ROIs as keys), OHEM, the
    RCNN losses and, with TRAIN.LEARN_NMS, the learned-NMS branch at class
    threshold 0 on the first ``nongt_dim`` ROIs (recomputed in the backward
    under TPU.LNMS_REMAT). ``parts`` are the losses to add to the total, in
    the order the JAX package adds them. ``stop_after`` 'head' leaves the
    branch out; 'lnms_embed' and 'lnms_attn' cut it inside the head (its
    probes, run inside the recomputed branch under TPU.LNMS_REMAT),
    'lnms_score' and 'lnms_target' after it (make_train_step)."""
    # made once here, on the model's device (see target_constants)
    threshes = torch.tensor(
        np.fromstring(cfg.network.NMS_TARGET_THRESH, dtype=float,
                      sep=",").tolist(),
        dtype=torch.float32, device=next(model.parameters()).device)
    ohem = bool(cfg.TRAIN.ENABLE_OHEM)
    learn_nms = bool(cfg.TRAIN.LEARN_NMS) and stop_after != "head"
    remat = bool(cfg.TPU.get("LNMS_REMAT", False))
    batch_rois = int(cfg.TRAIN.BATCH_ROIS)
    bbox_norm_denom = float(cfg.TRAIN.BATCH_ROIS_OHEM if ohem
                            else (300 if batch_rois < 0 else batch_rois))

    def lnms_branch(cls_score, bbox_pred, rois, fc2, im_info, gt_boxes,
                    gt_valid):
        """(total, pos loss, neg loss, pos accuracy, neg accuracy)."""
        ln = model.learn_nms(cls_score, bbox_pred, rois, fc2, im_info,
                             probe=LNMS_PROBES.get(stop_after, ""))
        if stop_after in ("lnms_embed", "lnms_attn", "lnms_score"):
            t = 1e-30 * (torch.sum(ln["nms_multi_score"])
                         + torch.sum(ln["sorted_bbox"]))
            return t, t, t, t, t
        nt = nms_multi_target(ln["sorted_bbox"], gt_boxes, gt_valid,
                              ln["sorted_score"].detach(), threshes)
        if stop_after == "lnms_target":
            t = 1e-30 * (torch.sum(ln["nms_multi_score"])
                         + torch.sum(nt.float()))
            return t, t, t, t, t
        nms_total, pos_l, neg_l = learn_nms_losses(
            ln["nms_multi_score"], nt, float(cfg.TRAIN.nms_loss_scale),
            float(cfg.TRAIN.nms_pos_scale))
        acc_pos, acc_neg = nms_accuracy(ln["nms_multi_score"], nt)
        return nms_total, pos_l, neg_l, acc_pos, acc_neg

    def losses(feat, tgt, nongt_dim, im_info, gt_boxes, gt_valid):
        cls_score, bbox_pred, fc2 = model.head(feat, tgt["rois"], nongt_dim)
        rlabel, rweight = tgt["label"], tgt["bbox_weight"]
        if ohem:
            rlabel, rweight = ohem_select(cls_score, bbox_pred, rlabel,
                                          tgt["bbox_target"], rweight,
                                          int(cfg.TRAIN.BATCH_ROIS_OHEM))
        rcnn_cls_loss, rcnn_bbox_loss = rcnn_losses(
            cls_score, bbox_pred, rlabel, tgt["bbox_target"], rweight,
            bbox_norm_denom)
        parts = [rcnn_cls_loss, rcnn_bbox_loss]
        metrics = {"rcnn_cls_loss": rcnn_cls_loss,
                   "rcnn_bbox_loss": rcnn_bbox_loss,
                   "rcnn_acc": accuracy_ignore(cls_score, rlabel)}
        if learn_nms:
            args = (cls_score[:nongt_dim], bbox_pred[:nongt_dim],
                    tgt["rois"][:nongt_dim], fc2[:nongt_dim], im_info,
                    gt_boxes, gt_valid)
            if remat and torch.is_grad_enabled():
                out = torch.utils.checkpoint.checkpoint(
                    lnms_branch, *args, use_reentrant=False)
            else:
                out = lnms_branch(*args)
            nms_total, pos_l, neg_l, acc_pos, acc_neg = out
            parts.append(nms_total)
            metrics.update({"nms_pos_loss": pos_l, "nms_neg_loss": neg_l,
                            "nms_acc_pos": acc_pos, "nms_acc_neg": acc_neg})
        return parts, metrics
    return losses


@trace.span("step", request=True)
def run_step(model, state: TrainState, batch, priorities, per_image, *,
             step_mask: dict, no_grad: bool, device, pixel_means, mesh=None,
             draw=None, reaches_params: bool = True):
    """One step over a batch: the batch to ``device`` (uint8 images
    mean-subtracted there), the conv trunk and RPN batched, ``per_image(feat,
    rpn, inputs, generator, prio) -> (total, metrics)`` for each image
    (``inputs``: its slice of every batch entry but the image), the mean
    loss's gradient with only the ``step_mask`` leaves requiring one, and
    the optimizer's update in place. Returns (state, batch-mean metrics).

    With a ``mesh`` of several ranks, the gradients of the ``step_mask``
    leaves (zeros where a leaf got none) and the metrics are averaged over
    the ranks before the update, and ``draw(rpn, n_images, n_gt,
    generator)`` gives the global batch's priorities when the caller gave
    none; this rank keeps its share. ``reaches_params`` False (a cut whose
    loss reaches no parameter: the RCNN step's 'sample') skips the backward
    and leaves every gradient at zero, as JAX's is, and so does a
    ``step_mask`` that trains no leaf (tools/train_cuts.py's f_all leg);
    otherwise a loss without a graph raises."""
    from relation_tpu_torch.core.predictor import _image_from_u8
    from relation_tpu_torch.parallel.mesh import all_reduce_mean
    if state.model is not model:
        raise ValueError("train_step: the state belongs to another model")
    dp = mesh is not None and mesh.distributed
    if dp and draw is None:
        raise ValueError("this step has no data-parallel form")
    with trace.span("step.input"):
        image = torch.as_tensor(batch["image"], device=device)
        ins = {}
        for k, v in batch.items():
            if k != "image":
                v = torch.as_tensor(v, device=device)
                ins[k] = v.bool() if k.endswith("valid") else v.float()
        B = image.shape[0]
        if priorities is not None and len(priorities) != B:
            raise ValueError(f"priorities for {len(priorities)} images, "
                             f"batch of {B}")
        if image.dtype == torch.uint8:
            means = tuple(float(m) for m in pixel_means)
            image = torch.stack([_image_from_u8(image[b], ins["im_info"][b],
                                                means) for b in range(B)])
    _set_requires_grad(model, step_mask)
    with torch.set_grad_enabled(not no_grad):
        with trace.span("step.trunk_rpn"):
            if isinstance(model, RelationRCNNFPN):
                pyramid, rpn_out = model.features_and_rpn(image)
                feats = [{s: f[b] for s, f in pyramid.items()}
                         for b in range(B)]
                rpns = [{s: (c[b], r[b]) for s, (c, r) in rpn_out.items()}
                        for b in range(B)]
            else:
                feat, rpn_cls, rpn_bbox = model.features_and_rpn(image)
                feats, rpns = list(feat), list(zip(rpn_cls, rpn_bbox))
        with trace.span("step.rois"):
            if dp and priorities is None:
                every = draw(rpns[0], B * mesh.world, ins["gt_boxes"].shape[1],
                             state.generator)
                priorities = every[mesh.rank * B:(mesh.rank + 1) * B]
            totals, per = [], []
            for b in range(B):
                tot, m = per_image(feats[b], rpns[b],
                                   {k: v[b] for k, v in ins.items()},
                                   state.generator,
                                   None if priorities is None else priorities[b])
                totals.append(tot)
                per.append(m)
            loss = torch.stack(totals).mean()
            names = sorted(per[0])
            metrics = torch.stack([torch.stack([m[k] for m in per]).mean()
                                   .detach() for k in names])
        if not no_grad:
            with trace.span("step.backward"):
                for p in model.parameters():
                    p.grad = None
                if reaches_params and any(step_mask.values()):
                    loss.backward()
            if dp:
                with trace.span("step.allreduce"):
                    grads = []
                    for n, p in model.named_parameters():
                        if step_mask[n]:
                            if p.grad is None:
                                p.grad = torch.zeros_like(p)
                            grads.append(p.grad)
                    all_reduce_mean(mesh, grads + [metrics])
            with trace.span("step.update"):
                state.tx.update(model, state.trace, state.count)
                for p in model.parameters():
                    p.grad = None
            state.count += 1
        elif dp:
            with trace.span("step.allreduce"):
                all_reduce_mean(mesh, [metrics])
    state.step += 1
    return state, dict(zip(names, metrics.unbind()))
