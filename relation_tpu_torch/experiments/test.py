"""Evaluation driver of the port (counterpart of experiments/test.py;
reference relation_rcnn/test.py:23-79).

    python -m relation_tpu_torch.experiments.test --cfg experiments/cfgs/<name>.yaml \\
        [--ckpt path | --test-epoch E] [--thresh 1e-3] [--softnms] [--naive-nms]
        [--first-n N] [--ignore-cache] [--vis] [--shuffle] [--debug]
        [--dataset-path ROOT] [--tiny] [--device cpu]

The flags set TEST keys as the reference's do (test.py:31-53), then
core/evaluator.py::pred_eval runs over annotations/instances_<test set>.json
and images/<test set>/ of the dataset: the detections cache and the results
JSON under <output_path>/<cfg>/<test set>/, the COCO summary in the log.
The parameters come from ``--ckpt`` (a params file or a checkpoint, of
either package), else from the train driver's file of ``--test-epoch`` or
TEST.test_epoch, else ``init_params(model, seed=0)``. With TEST.HAS_RPN
false the head runs on cached proposals (``resolve_proposal_file``).

A checkpoint whose ``__meta__`` says ``roi_method: pool`` (converted
reference weights, relation_tpu_torch/tools/convert_reference_params.py)
runs in the JAX driver's parity mode: exact ROIPooling, the exact FPN
top-k, the f32 geometric-bias sinusoid, the dense learned-NMS attention
(NMS_COMPACT_CLASSES 0) and the f32 deformable PSROI pool
(``apply_roi_method``); ``--roi-method pool|align`` overrides the tag.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Test Relation R-CNN (PyTorch)")
    p.add_argument("--cfg", required=True)
    p.add_argument("--ckpt", default="")
    p.add_argument("--thresh", type=float, default=1e-3)
    p.add_argument("--softnms", action="store_true")
    p.add_argument("--naive-nms", action="store_true",
                   help="force greedy NMS (disable learned NMS)")
    p.add_argument("--first-n", type=int, default=0)
    p.add_argument("--test-set", default="")
    p.add_argument("--ignore-cache", action="store_true")
    p.add_argument("--nms", type=float, default=0.0,
                   help="override TEST.NMS threshold")
    p.add_argument("--merge", type=int, default=-10,
                   help="override TEST.MERGE_METHOD (-1 mean, -2 max, >=0 index)")
    p.add_argument("--vis", action="store_true",
                   help="write detection renderings next to the cache "
                        "(needs matplotlib)")
    p.add_argument("--shuffle", action="store_true",
                   help="shuffle the image order (reference test.py:43; "
                        "changes which images --vis renders, not the mAP)")
    p.add_argument("--debug", action="store_true",
                   help="the predictor's monitor taps (TPU.DEBUG_MONITOR): "
                        "logs per-image tensor stats")
    p.add_argument("--test-epoch", type=int, default=0,
                   help="epoch to evaluate (reference test.py:44): the train "
                        "driver's <model_prefix>-EEEE.params.msgpack; --ckpt "
                        "wins; 0 falls back to cfg.TEST.test_epoch when that "
                        "file exists")
    p.add_argument("--dataset-path", default="",
                   help="override cfg.dataset.dataset_path")
    p.add_argument("--tiny", action="store_true",
                   help="tiny backbone (must match how the ckpt was trained)")
    p.add_argument("--roi-method", default="auto",
                   choices=("auto", "align", "pool"),
                   help="ROI feature extraction; auto = the checkpoint's "
                        "__meta__ roi_method, else cfg default")
    p.add_argument("--device", default="cuda")
    # the sibling driver's flags only (rcnn_end2end_train_test.py forwards
    # one argv to both drivers); anything else is an error
    p.add_argument("--synthetic", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--steps", type=int, default=0, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def resolve_proposal_file(cfg, cfg_name: str) -> str:
    """The cached proposals of TEST.HAS_RPN=false (reference
    function/test_rcnn.py:40-51, lib/dataset/imdb.py:105-107), first found
    of: ``<proposal_cache>/rpn_data/<set>_rpn.pkl``,
    ``<proposal_cache>/<set>_rpn.pkl``, and the pickle
    experiments/rcnn_train_test.py writes beside this config's train
    outputs."""
    s_test = cfg.dataset.test_image_set
    candidates = [
        os.path.join(cfg.dataset.proposal_cache or "", "rpn_data",
                     f"{s_test}_rpn.pkl"),
        os.path.join(cfg.dataset.proposal_cache or "", f"{s_test}_rpn.pkl"),
        os.path.join(cfg.output_path or "output", cfg_name,
                     cfg.dataset.image_set, f"{s_test}_rpn.pkl"),
    ]
    found = next((c for c in candidates if os.path.exists(c)), None)
    if found is None:
        raise FileNotFoundError(
            f"TEST.HAS_RPN=false needs cached proposals for '{s_test}'; "
            f"looked in: {candidates}. Generate them with "
            "experiments/rcnn_train_test.py (stage 2) or set "
            "TEST.HAS_RPN=true to use this model's own RPN.")
    return found


def apply_flags(cfg, args) -> None:
    """The flags' TEST / dataset / TPU keys (reference test.py:31-53)."""
    if args.softnms:
        cfg.TEST.SOFTNMS = True
    if args.naive_nms:
        cfg.TEST.LEARN_NMS = False
    if args.first_n:
        cfg.TEST.FIRST_N = args.first_n
    if args.test_set:
        cfg.dataset.test_image_set = args.test_set
    if args.dataset_path:
        cfg.dataset.dataset_path = args.dataset_path
    cfg.TEST.SCORE_THRESH = args.thresh
    if args.nms:
        cfg.TEST.NMS = args.nms
    if args.merge != -10:
        cfg.TEST.MERGE_METHOD = args.merge
    if args.debug:
        cfg.TPU.DEBUG_MONITOR = True


# the keys the parity mode sets, printed by main as "ROI settings: {json}"
ROI_KEYS = ("ROI_METHOD", "FPN_TOPK", "GEOM_EMB_DTYPE", "NMS_COMPACT_CLASSES",
            "DCN_POOL_DTYPE")


def apply_roi_method(cfg, roi_method: str, meta: dict) -> None:
    """TPU.ROI_METHOD from ``--roi-method`` (``roi_method`` not "auto"), or
    from a checkpoint's ``__meta__`` tag; a tag of "pool" (converted
    reference weights, whose head is the reference's rounding max-pool
    ROIPooling, resnet_v1_101_rcnn_base.py:790) also sets the JAX driver's
    full parity mode (experiments/test.py:143-161): the exact pre-NMS top-k
    of the FPN proposals, the f32 geometric-bias sinusoid, the single dense
    learned-NMS attention and the f32 deformable PSROI pool."""
    if roi_method != "auto":
        cfg.TPU.ROI_METHOD = roi_method
    elif meta.get("roi_method"):
        cfg.TPU.ROI_METHOD = meta["roi_method"]
        print(f"checkpoint meta: roi_method={meta['roi_method']} "
              f"(source={meta.get('source', '?')})")
        if meta["roi_method"] == "pool":
            cfg.TPU.FPN_TOPK = "exact"
            cfg.TPU.GEOM_EMB_DTYPE = "float32"
            cfg.TPU.NMS_COMPACT_CLASSES = 0
            cfg.TPU.DCN_POOL_DTYPE = "float32"


def epoch_params_path(cfg, cfg_path: str, epoch: int) -> str:
    """The train driver's params file of ``epoch`` (under the TRAIN image
    set's directory)."""
    cfg_name = os.path.splitext(os.path.basename(cfg_path))[0]
    prefix = os.path.join(cfg.output_path or "output", cfg_name,
                          cfg.dataset.image_set,
                          cfg.TRAIN.model_prefix or "model")
    return f"{prefix}-{epoch:04d}.params.msgpack"


def main(argv=None, image_loader=None, stats: dict | None = None):
    """Runs the evaluation; returns (results, {image_id: dets}).
    ``image_loader`` replaces the loader's file decode; a dict ``stats``
    gets pred_eval's timing split (core/evaluator.py::pred_eval)."""
    args = parse_args(argv)
    from relation_tpu_torch.config.defaults import load_config
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.checkpoint import (params_from_blob,
                                                    read_params_blob)
    from relation_tpu_torch.core.evaluator import pred_eval
    from relation_tpu_torch.core.trainer import build_model
    from relation_tpu_torch.data.coco import coco_dataset
    from relation_tpu_torch.data.loader import ProposalTestLoader, TestLoader
    from relation_tpu_torch.utils.compile_cache import enable_from_env_or_cfg
    from relation_tpu_torch.utils.logging import create_logger

    cfg = load_config(args.cfg)
    apply_flags(cfg, args)
    if not args.ckpt:
        # the reference's --test_epoch (test.py:44,75)
        epoch = args.test_epoch or int(cfg.TEST.test_epoch)
        if epoch:
            cand = epoch_params_path(cfg, args.cfg, epoch)
            if args.test_epoch and not os.path.exists(cand):
                raise FileNotFoundError(f"--test-epoch {epoch}: {cand}")
            if os.path.exists(cand):
                args.ckpt = cand
    blob, meta = read_params_blob(args.ckpt) if args.ckpt else (None, {})
    apply_roi_method(cfg, args.roi_method, meta)
    print("ROI settings: " + json.dumps({k: cfg.TPU.get(k) for k in ROI_KEYS}),
          flush=True)

    enable_from_env_or_cfg(cfg)
    cfg_name = os.path.splitext(os.path.basename(args.cfg))[0]
    logger, out_path = create_logger(cfg.output_path or "output", cfg_name,
                                     cfg.dataset.test_image_set)
    s = cfg.dataset.test_image_set
    dataset = coco_dataset(cfg.dataset.dataset_path, s)
    roidb = dataset.roidb()
    if args.shuffle:
        # reference TestLoader(shuffle=True) (function/test_rcnn.py:54); the
        # cache and the evaluation key on image id
        np.random.shuffle(roidb)
    proposal_file = None
    if not bool(cfg.TEST.HAS_RPN):
        proposal_file = resolve_proposal_file(cfg, cfg_name)
        logger.info(f"HAS_RPN=false: cached proposals from {proposal_file}")

    model = build_model(cfg, tiny=args.tiny, device=args.device)
    if args.ckpt:
        model.load_state_dict(params_from_blob(blob, model))
        logger.info(f"loaded params: {args.ckpt}")
    else:
        init_params(model, seed=0)
    loader = None
    if image_loader is not None:
        loader = (ProposalTestLoader(roidb, cfg, proposal_file,
                                     image_loader=image_loader)
                  if proposal_file else
                  TestLoader(roidb, cfg, image_loader=image_loader))
    results, dets = pred_eval(
        model, cfg, dataset, roidb, logger,
        cache_path=os.path.join(out_path, "detections.pkl"),
        ignore_cache=args.ignore_cache, loader=loader,
        proposal_file=proposal_file, stats=stats)
    if args.vis:
        # reference --vis (test.py:32, tester.py vis_all_detection)
        from relation_tpu_torch.data.image import load_image_bgr
        from relation_tpu_torch.utils.vis import draw_detections
        vis_dir = os.path.join(out_path, "vis")
        os.makedirs(vis_dir, exist_ok=True)
        names = ["bg"] + list(dataset.class_names)
        for entry in roidb[:50]:
            d = dets.get(entry.get("image_id", entry["image"]))
            if d is None:
                continue
            draw_detections(
                (image_loader or load_image_bgr)(entry["image"]), d, names,
                thresh=max(args.thresh, 0.3),
                out_path=os.path.join(
                    vis_dir, os.path.basename(str(entry["image"])) + ".png"))
        logger.info(f"wrote visualizations: {vis_dir}")
    print(results)
    return results, dets


if __name__ == "__main__":
    main()
