"""Entry point of the port: the counterpart of ``__graft_entry__.py::entry``
of the JAX package, for the flagship, its DCN siblings and the FPN family.

    from relation_tpu_torch.entry import entry
    predict, (image, im_info) = entry()                  # flagship, on the card
    predict, (image, im_info) = entry("dcn_relation")    # a DCN family
    predict, (image, im_info) = entry("fpn_learn_nms")   # an FPN family
    dets = predict(image, im_info)["dets"]               # [100, 6]

The flagship is resnet_v1_101_rcnn_attention_1024_pairwise_position_
multi_head_16_learn_nms: ResNet-101 C4 + dilated C5, 81 classes, 6000 -> 300
proposals, two relation modules and the learned-NMS head (FIRST_N 100), on
the 608x1024 bucket with the s2d planar [12, 304, 512] input. The DCN
families replace res5 by the deformable res5 and the ROI pool by the
deformable PSROI head, with the test-time settings of their experiment
YAMLs (experiments/cfgs/*_rcnn_dcn_end2end*.yaml):

    dcn            plain 2FC head, soft-NMS tail (TEST.NMS 0.6)
    dcn_relation   relation head, greedy per-class NMS tail (TEST.NMS 0.3)
    dcn_learn_nms  relation head, learned-NMS tail

The FPN families are the same three heads and tails on the FPN detector
(ResNet-101 res2..res5 at strides 4..32, the FPN neck with P2..P6, one RPN
over the five levels with one scale and three ratios, 3 x 51,840 anchors at
608x1024, ROIs pooled at their dispatch level), with the settings of
experiments/cfgs/*_rcnn_fpn*_8epoch.yaml: fpn, fpn_relation and
fpn_learn_nms (FIRST_N 150, LEARN_NMS_CLASS_SCORE_TH 0.05). The YAMLs train
and test from cached proposals (TRAIN.END2END and TEST.HAS_RPN False), the
workflow of core/rpn_workflow.py, whose keys family_cfg sets as they do
(FIXED_PARAMS_SHARED, TOP_ROIS 1000, TEST.PROPOSAL_* 20000 -> 2000); entry()
serves them as the JAX package's make_predict_fn does, with the RPN on the
device, through core/predictor.py::build_predict_fn, so fpn_learn_nms takes
the TPU.FPN_SPLIT_PREDICT form by default.
"""

from __future__ import annotations

import torch

from relation_tpu_torch.config.defaults import default_config

FLAGSHIP_SYMBOL = ("resnet_v1_101_rcnn_attention_1024_pairwise_position_"
                   "multi_head_16_learn_nms")
# family -> (symbol, learned NMS, TEST.NMS, TEST.SOFTNMS)
FAMILIES = {
    "flagship": (FLAGSHIP_SYMBOL, True, 10.0, True),
    "dcn": ("resnet_v1_101_rcnn_dcn", False, 0.6, True),
    "dcn_relation": ("resnet_v1_101_rcnn_dcn_attention_1024_pairwise_position_"
                     "multi_head_16", False, 0.3, False),
    "dcn_learn_nms": ("resnet_v1_101_rcnn_dcn_attention_1024_pairwise_position_"
                      "multi_head_16_learn_nms", True, 10.0, True),
    "fpn": ("resnet_v1_101_rcnn_fpn", False, 0.6, True),
    "fpn_relation": ("resnet_v1_101_rcnn_fpn_attention_1024_pairwise_position_"
                     "multi_head_16", False, 0.3, False),
    "fpn_learn_nms": ("resnet_v1_101_rcnn_fpn_attention_1024_pairwise_position_"
                      "multi_head_16_learn_nms", True, 10.0, True),
}
BUCKET = (608, 1024)


def family_cfg(family: str = "flagship", tiny_shapes: bool = False):
    """The config of one family of FAMILIES at the widths of its experiment
    YAML; ``tiny_shapes`` cuts the proposal counts for a CPU rehearsal."""
    symbol, learn_nms, nms, softnms = FAMILIES[family]
    cfg = default_config()
    cfg.symbol = symbol
    cfg.CLASS_AGNOSTIC = True
    cfg.dataset.NUM_CLASSES = 81
    cfg.network.ANCHOR_SCALES = (4, 8, 16, 32)
    cfg.network.ANCHOR_RATIOS = (0.5, 1, 2)
    cfg.network.NUM_ANCHORS = 12
    cfg.network.NMS_TARGET_THRESH = "0.5, 0.6, 0.7, 0.8, 0.9"
    cfg.network.FIXED_PARAMS = ["conv1", "bn_conv1", "res2", "bn2", "gamma", "beta"]
    cfg.TRAIN.LEARN_NMS = learn_nms
    cfg.TRAIN.JOINT_TRAINING = learn_nms
    cfg.TRAIN.BATCH_ROIS = -1
    cfg.TRAIN.ENABLE_OHEM = True
    cfg.TRAIN.BATCH_ROIS_OHEM = 128
    cfg.TRAIN.FIRST_N = 100
    cfg.TRAIN.BBOX_NORMALIZATION_PRECOMPUTED = True
    cfg.TRAIN.lr = 0.0005
    cfg.TRAIN.lr_step = "5.33"
    cfg.TRAIN.RPN_MIN_SIZE = 0
    cfg.TEST.LEARN_NMS = learn_nms
    cfg.TEST.NMS = nms
    cfg.TEST.SOFTNMS = softnms
    cfg.TEST.FIRST_N = 100
    cfg.TEST.HAS_RPN = True
    cfg.TEST.RPN_MIN_SIZE = 0
    cfg.TEST.max_per_image = 100
    first_n = 100
    if family.startswith("fpn"):
        # one scale a level: 3 anchors per cell on each of P2..P6
        cfg.network.ANCHOR_SCALES = (8,)
        cfg.network.NUM_ANCHORS = 3
        cfg.TRAIN.lr = 0.00125
        cfg.TRAIN.BATCH_ROIS_OHEM = 512
        if learn_nms:
            first_n = 150
            cfg.TEST.LEARN_NMS_CLASS_SCORE_TH = 0.05
        # the alternate workflow's keys (core/rpn_workflow.py): the trunk
        # shared with the RPN, one image a batch, the proposal dump's top
        # 2000 of 20000 at min size 0, 1000 cached ROIs an image
        cfg.network.FIXED_PARAMS_SHARED = [
            "conv1", "bn_conv1", "res2", "bn2", "res3", "bn3", "res4", "bn4",
            "gamma", "beta"]
        cfg.TRAIN.BATCH_IMAGES = 1
        cfg.TEST.PROPOSAL_PRE_NMS_TOP_N = 128 if tiny_shapes else 20000
        cfg.TEST.PROPOSAL_POST_NMS_TOP_N = 64 if tiny_shapes else 2000
        cfg.TEST.PROPOSAL_MIN_SIZE = 0
        cfg.TRAIN.TOP_ROIS = cfg.TEST.TOP_ROIS = 40 if tiny_shapes else 1000
    pre, post, first_n = (128, 48, 16) if tiny_shapes else (6000, 300, first_n)
    for sec in (cfg.TRAIN, cfg.TEST):
        sec.RPN_PRE_NMS_TOP_N = pre
        sec.RPN_POST_NMS_TOP_N = post
        sec.FIRST_N = first_n
    return cfg


def flagship_cfg(tiny_shapes: bool = False):
    """The config of ``__graft_entry__.py::_flagship_cfg``."""
    return family_cfg("flagship", tiny_shapes)


def entry(family: str = "flagship", device="cuda", seed: int = 0, cfg=None):
    """(predict, (image, im_info)): one family at full width with weights
    from ``init_params(model, seed)``, and a zero s2d image of the 608x1024
    bucket with its im_info, on ``device``. ``cfg`` (default
    ``family_cfg(family)``) is the config the model is built from.

    The predict function is core/predictor.py::build_predict_fn's: for
    fpn_learn_nms with TPU.FPN_SPLIT_PREDICT (on by default) the split form.
    With cfg.TPU.FUSE_RES4 set, a C4 model's predict runs res4b1..b22 as the
    fused stack kernel on weights folded once and kept with the model
    (core/predictor.py::prepare_res4_folded), as __graft_entry__.py::entry
    does. ``predict.model`` is the model it serves."""
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.predictor import (build_predict_fn,
                                                   prepare_res4_folded)
    from relation_tpu_torch.core.trainer import build_model

    cfg = family_cfg(family) if cfg is None else cfg
    model = init_params(build_model(cfg, device=device), seed)
    H, W = BUCKET
    dev = next(model.parameters()).device
    image = torch.zeros((12, H // 2, W // 2), dtype=torch.float32, device=dev)
    im_info = torch.tensor([600.0, 1000.0, 1.667], device=dev)
    predict_fn = build_predict_fn(model, cfg)
    fuse = bool(cfg.TPU.get("FUSE_RES4", False))
    prepare_res4_folded(model, fuse)

    def predict(image, im_info):
        # the folds kept with the model (folded again only after a weight
        # changed)
        return predict_fn(image, im_info, prepare_res4_folded(model, fuse))
    predict.tail, predict.model = predict_fn.tail, model
    return predict, (image, im_info)
