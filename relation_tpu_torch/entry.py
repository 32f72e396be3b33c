"""Entry point of the port: the counterpart of ``__graft_entry__.py::entry``
of the JAX package, for the flagship and its DCN siblings.

    from relation_tpu_torch.entry import entry
    predict, (image, im_info) = entry()                  # flagship, on the card
    predict, (image, im_info) = entry("dcn_relation")    # a DCN family
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
    pre, post, first_n = (128, 48, 16) if tiny_shapes else (6000, 300, 100)
    for sec in (cfg.TRAIN, cfg.TEST):
        sec.RPN_PRE_NMS_TOP_N = pre
        sec.RPN_POST_NMS_TOP_N = post
        sec.FIRST_N = first_n
    return cfg


def flagship_cfg(tiny_shapes: bool = False):
    """The config of ``__graft_entry__.py::_flagship_cfg``."""
    return family_cfg("flagship", tiny_shapes)


def entry(family: str = "flagship", device="cuda", seed: int = 0):
    """(predict, (image, im_info)): one family at full width with weights
    from ``init_params(model, seed)``, and a zero s2d image of the 608x1024
    bucket with its im_info, on ``device``."""
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.predictor import make_predict_fn
    from relation_tpu_torch.core.trainer import build_model

    cfg = family_cfg(family)
    model = init_params(build_model(cfg, device=device), seed)
    H, W = BUCKET
    dev = next(model.parameters()).device
    image = torch.zeros((12, H // 2, W // 2), dtype=torch.float32, device=dev)
    im_info = torch.tensor([600.0, 1000.0, 1.667], device=dev)
    return make_predict_fn(model, cfg), (image, im_info)
