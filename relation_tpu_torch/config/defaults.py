"""Default configuration tree + YAML overlay (the port's own copy of
relation_tpu/config/defaults.py; PyYAML is imported only when a file is loaded).

Schema-compatible with the reference's config layer
(reference: relation_rcnn/config/config.py:18-198): the same key names, the same
layering (hard defaults -> YAML overlay with strict key-existence validation), so the
reference's ``experiments/relation_rcnn/cfgs/*.yaml`` files load unmodified.

TPU-native additions live under ``config.TPU`` (static-shape bucketing, dtype policy,
mesh axes); every addition has a safe default so reference YAMLs need no edits.
"""

from __future__ import annotations

import numpy as np

from relation_tpu_torch.utils.attrdict import AttrDict


def default_config() -> AttrDict:
    config = AttrDict()

    config.MXNET_VERSION = ""  # accepted for YAML compatibility; unused
    config.output_path = ""
    config.symbol = ""
    config.gpus = ""  # accepted for YAML compatibility; device count comes from JAX
    config.CLASS_AGNOSTIC = True
    config.SCALES = [(600, 1000)]  # (short side, max long side)

    config.default = AttrDict()
    config.default.frequent = 20
    config.default.kvstore = "device"  # unused; DP gradient allreduce is XLA psum

    # network related params (reference config.py:33-47)
    network = config.network = AttrDict()
    network.pretrained = ""
    network.pretrained_epoch = 0
    network.PIXEL_MEANS = np.array([0, 0, 0])
    network.IMAGE_STRIDE = 0
    network.RPN_FEAT_STRIDE = 16
    network.RCNN_FEAT_STRIDE = 16
    network.FIXED_PARAMS = ["gamma", "beta"]
    network.FIXED_PARAMS_SHARED = ["gamma", "beta"]
    network.ANCHOR_SCALES = (8, 16, 32)
    network.ANCHOR_RATIOS = (0.5, 1, 2)
    network.NUM_ANCHORS = len(network.ANCHOR_SCALES) * len(network.ANCHOR_RATIOS)
    network.ROIDispatch = False
    network.USE_NONGT_INDEX = False
    network.NMS_TARGET_THRESH = "0.5"

    # dataset related params (reference config.py:50-56)
    dataset = config.dataset = AttrDict()
    dataset.dataset = "PascalVOC"
    dataset.image_set = "2007_trainval"
    dataset.test_image_set = "2007_test"
    dataset.root_path = "./data"
    dataset.dataset_path = "./data/VOCdevkit"
    dataset.NUM_CLASSES = 21
    dataset.proposal = "rpn"
    # directory of cached RPN proposal pkls for the separate-RCNN workflow
    # (the FPN cfgs set this; reference config.py has no default — its
    # update_config admits unknown NESTED keys silently, config.py:188-189.
    # We validate recursively instead, so the key needs a default.)
    dataset.proposal_cache = ""

    TRAIN = config.TRAIN = AttrDict()
    TRAIN.lr = 0
    TRAIN.lr_step = ""
    TRAIN.lr_factor = 0.1
    TRAIN.warmup = False
    TRAIN.warmup_lr = 0
    TRAIN.warmup_step = 0
    TRAIN.momentum = 0.9
    TRAIN.wd = 0.0005
    TRAIN.begin_epoch = 0
    TRAIN.end_epoch = 0
    TRAIN.model_prefix = ""
    TRAIN.rpn_loss_scale = 3.0
    TRAIN.nms_loss_scale = 1.0
    TRAIN.nms_pos_scale = 4.0

    TRAIN.ALTERNATE = AttrDict()
    TRAIN.ALTERNATE.RPN_BATCH_IMAGES = 0
    TRAIN.FC_DROPOUT_RATIO = 0
    TRAIN.ATTENTION_DROPOUT_RATIO = 0
    TRAIN.ATTENTION_SCALE_METHOD = 0
    TRAIN.RESUME = False
    TRAIN.FLIP = True
    TRAIN.SHUFFLE = True
    TRAIN.ENABLE_OHEM = False
    TRAIN.BATCH_IMAGES = 2
    TRAIN.END2END = False
    TRAIN.ASPECT_GROUPING = True

    # R-CNN sampling (reference config.py:96-108)
    TRAIN.TOP_ROIS = -1
    TRAIN.BATCH_ROIS = 128
    TRAIN.BATCH_ROIS_OHEM = 128
    TRAIN.FG_FRACTION = 0.25
    TRAIN.FG_THRESH = 0.5
    TRAIN.BG_THRESH_HI = 0.5
    TRAIN.BG_THRESH_LO = 0.0
    TRAIN.BBOX_REGRESSION_THRESH = 0.5
    TRAIN.BBOX_WEIGHTS = np.array([1.0, 1.0, 1.0, 1.0])

    # RPN anchor sampling (reference config.py:110-120)
    TRAIN.RPN_BATCH_SIZE = 256
    TRAIN.RPN_FG_FRACTION = 0.5
    TRAIN.RPN_POSITIVE_OVERLAP = 0.7
    TRAIN.RPN_NEGATIVE_OVERLAP = 0.3
    TRAIN.RPN_CLOBBER_POSITIVES = False
    TRAIN.RPN_BBOX_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
    TRAIN.RPN_POSITIVE_WEIGHT = -1.0

    # end2end RPN proposal (reference config.py:122-128)
    TRAIN.CXX_PROPOSAL = True  # accepted; both paths are the same on-device op here
    TRAIN.RPN_NMS_THRESH = 0.7
    TRAIN.RPN_PRE_NMS_TOP_N = 12000
    TRAIN.RPN_POST_NMS_TOP_N = 2000
    TRAIN.RPN_MIN_SIZE = network.RPN_FEAT_STRIDE
    TRAIN.BBOX_NORMALIZATION_PRECOMPUTED = False
    TRAIN.BBOX_MEANS = (0.0, 0.0, 0.0, 0.0)
    TRAIN.BBOX_STDS = (0.1, 0.1, 0.2, 0.2)
    TRAIN.LEARN_NMS = False
    TRAIN.JOINT_TRAINING = False
    TRAIN.FIRST_N = 100

    TEST = config.TEST = AttrDict()
    TEST.HAS_RPN = False
    TEST.BATCH_IMAGES = 1
    TEST.TOP_ROIS = 2000
    TEST.CXX_PROPOSAL = True
    TEST.RPN_NMS_THRESH = 0.7
    TEST.RPN_PRE_NMS_TOP_N = 6000
    TEST.RPN_POST_NMS_TOP_N = 300
    TEST.RPN_MIN_SIZE = network.RPN_FEAT_STRIDE
    TEST.PROPOSAL_NMS_THRESH = 0.7
    TEST.PROPOSAL_PRE_NMS_TOP_N = 20000
    TEST.PROPOSAL_POST_NMS_TOP_N = 2000
    TEST.PROPOSAL_MIN_SIZE = network.RPN_FEAT_STRIDE
    TEST.SOFTNMS = False
    TEST.LEARN_NMS = False
    TEST.FIRST_N = 0
    TEST.MERGE_METHOD = -1
    TEST.NMS = 0.3
    TEST.max_per_image = 300
    TEST.test_epoch = 0
    TEST.LEARN_NMS_CLASS_SCORE_TH = 0.01
    # per-detection score floor at eval (the reference test.py --thresh flag,
    # default 1e-3, reference test.py:31 + tester.py:230)
    TEST.SCORE_THRESH = 1e-3

    # ---- extensions of the JAX package (not present in the reference) ----
    # Kept key for key so that configs and YAMLs written for relation_tpu load
    # here unchanged. The port reads COMPUTE_DTYPE and HEAD_DTYPE (dtype
    # policy, core/trainer.py::build_model), ROI_METHOD, DCN_POOL_DTYPE,
    # FUSE_RES4 (the fused res4 stack kernel at inference, entry.py),
    # GRAD_CLIP, the learned-NMS attention's branch (LNMS_ATTN for C4
    # models, FPN_ALLOW_PALLAS for FPN models, NMS_COMPACT_CLASSES for both)
    # and FPN_SPLIT_PREDICT (core/predictor.py::build_predict_fn); the
    # others select TPU/XLA code paths of relation_tpu and are accepted and
    # ignored: GEOM_EMB_DTYPE (the kernels never materialise the sinusoid
    # and compute in f32) and FPN_TOPK (the top-k is exact) among them.
    TPU = config.TPU = AttrDict()
    TPU.IMAGE_BUCKETS = [(608, 1024), (800, 1024), (1024, 1024)]
    TPU.MAX_GT = 100
    TPU.COMPUTE_DTYPE = "bfloat16"     # conv trunk: "bfloat16" | "float32"
    TPU.HEAD_DTYPE = "float32"         # ROI-head FCs + relation matmuls
    TPU.MESH_DATA_AXIS = "data"
    TPU.NMS_EXACT = True
    TPU.S2D_INPUT = True
    TPU.H2D_UINT8 = True
    TPU.GEOM_EMB_DTYPE = "bfloat16"
    TPU.NMS_COMPACT_CLASSES = 32
    TPU.COMPILE_CACHE_DIR = ""
    TPU.EVAL_PIPELINE_DEPTH = 8
    TPU.EVAL_LOG_EVERY = 200
    TPU.ROI_METHOD = "align"           # only "align" is ported so far
    TPU.DCN_POOL_DTYPE = "bfloat16"
    TPU.LNMS_ATTN = "pallas"
    TPU.FPN_TOPK = "approx"
    TPU.FUSE_RES4 = False              # res4b1..b22 as one stack kernel
    TPU.GRAD_CLIP = 0.0
    TPU.FPN_SPLIT_PREDICT = True
    TPU.LNMS_REMAT = False
    TPU.FPN_ALLOW_PALLAS = False
    TPU.PREWARM_BUCKETS = True
    TPU.DEBUG_MONITOR = False

    return config


def _merge(config: AttrDict, overlay: dict, path: str = "") -> None:
    """Overlay ``overlay`` onto ``config`` with key-existence validation at
    EVERY nesting level, mirroring reference ``update_config``
    (config.py:177-198, which raises on unknown keys wherever they appear) —
    a typo'd ``TRAIN.LEARN_NMs: true`` is an error, not a silent no-op."""
    for k, v in overlay.items():
        if k not in config:
            raise ValueError(
                f"key {path + k!r} must exist in the default config (reference "
                "config.py:198 raises the same way)")
        if isinstance(v, dict) and isinstance(config[k], AttrDict):
            _merge(config[k], v, path + k + ".")
        elif k in ("BBOX_WEIGHTS", "PIXEL_MEANS"):
            config[k] = np.array(v)
        elif k == "SCALES":
            config[k][0] = tuple(v)
        else:
            config[k] = v


def update_config(config: AttrDict, config_file: str) -> AttrDict:
    """Load a YAML experiment file onto ``config`` (in place) and return it."""
    import yaml
    with open(config_file) as f:
        exp = yaml.safe_load(f)
    _merge(config, exp)
    return config


def load_config(config_file: str | None = None) -> AttrDict:
    cfg = default_config()
    if config_file is not None:
        update_config(cfg, config_file)
    return cfg
