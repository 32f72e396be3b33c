"""Model factory (port of the ``build_model`` registry of
relation_tpu/core/trainer.py:71-130). The training step comes in a later
slice of the port."""

from __future__ import annotations

import numpy as np
import torch

from relation_tpu_torch.models.backbone import Conv2d
from relation_tpu_torch.models.detector import RelationRCNN


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


def build_model(cfg, tiny: bool = False, device="cuda") -> RelationRCNN:
    """Instantiate the detector from a reference-schema config, on ``device``
    (``"meta"`` gives shapes without memory). Parameters are uninitialised:
    load them with ``load_state_dict`` (convert.py). Dtype policy of the JAX
    package: conv trunk in TPU.COMPUTE_DTYPE (bf16 by default), head in
    TPU.HEAD_DTYPE (f32 by default), everything f32 for tiny models.

    Ported so far: the C4 symbols (plain 2FC head or relation head, with or
    without learned NMS). DCN and FPN symbols raise."""
    sym = cfg.symbol
    if "dcn" in sym:
        raise NotImplementedError(
            f"{sym}: DCN symbols come with the DCN slice of the port "
            "(ROADMAP Queue 1, item 6)")
    if "fpn" in sym:
        raise NotImplementedError(
            f"{sym}: FPN symbols come with the FPN slice of the port "
            "(ROADMAP Queue 1, item 7)")
    threshes = np.fromstring(cfg.network.NMS_TARGET_THRESH, dtype=float, sep=",")
    precomputed = bool(cfg.TRAIN.BBOX_NORMALIZATION_PRECOMPUTED)
    conv_dtype = torch.float32 if tiny else _dtype(
        cfg.TPU.get("COMPUTE_DTYPE", "bfloat16"))
    head_dtype = torch.float32 if tiny else _dtype(
        cfg.TPU.get("HEAD_DTYPE", "bfloat16"))
    device = torch.device(device)
    if device.type != "meta":
        device = resolve_device(device)
    with torch.device(device):
        model = RelationRCNN(
            num_classes=int(cfg.dataset.NUM_CLASSES),
            num_anchors=int(cfg.network.NUM_ANCHORS),
            class_agnostic=bool(cfg.CLASS_AGNOSTIC),
            use_relation=any(t in sym for t in ("rcnn_attention",
                                                "dcn_attention",
                                                "fpn_attention")),
            use_learn_nms=bool(cfg.TRAIN.LEARN_NMS or cfg.TEST.LEARN_NMS),
            first_n=int(cfg.TRAIN.FIRST_N),
            num_thresh=len(threshes),
            bbox_means=tuple(cfg.TRAIN.BBOX_MEANS) if precomputed else None,
            bbox_stds=tuple(cfg.TRAIN.BBOX_STDS) if precomputed else None,
            backbone="tiny" if tiny else "resnet101",
            head_dim=64 if tiny else 1024,
            rcnn_feat_stride=int(cfg.network.RCNN_FEAT_STRIDE),
            conv_dtype=conv_dtype, head_dtype=head_dtype)
    if str(cfg.TPU.get("ROI_METHOD", "align")) != "align":
        raise NotImplementedError("TPU.ROI_METHOD='pool' (exact ROIPooling) "
                                  "is not ported yet")
    # the conv layers store their weights in the compute dtype (the flax
    # modules cast f32 params at every call; rounding once is the same)
    for m in model.modules():
        if isinstance(m, Conv2d):
            m.to(conv_dtype)
    return model.eval()
