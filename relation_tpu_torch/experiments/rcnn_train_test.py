"""The alternate-workflow driver of the port (counterpart of
experiments/rcnn_train_test.py):

  1. train the RPN alone (core/rpn_workflow.py::make_train_step_rpn);
  2. dump its proposals over the training images (<image_set>_rpn.pkl) and
     report their recall;
  3. train the RCNN head on the cached proposals (every proposal of an
     image's dump, as the JAX driver's rcnn_batch), with the bbox-target
     statistics of the roidb's TRAIN.TOP_ROIS proposals when
     TRAIN.BBOX_NORMALIZATION_PRECOMPUTED is false; ``--train-shared``
     freezes network.FIXED_PARAMS_SHARED; save the checkpoint and the params
     file (core/checkpoint.py, the JAX package's format) under
     <output_path>/<cfg>/<image_set>/;
  4. with a dataset, dump the proposals of the test set
     (<test_image_set>_rpn.pkl) and evaluate from them
     (core/evaluator.py::pred_eval_rcnn, TEST.HAS_RPN false), if the test
     set's annotations exist.

    python -m relation_tpu_torch.experiments.rcnn_train_test \\
        --cfg experiments/cfgs/<fpn cfg>.yaml [--synthetic N | --dataset-path ROOT] \\
        [--steps K] [--tiny] [--train-shared] [--device cpu]

``--dataset-path ROOT`` reads the COCO layout under ROOT (annotations/
instances_<image_set>.json, images/<image_set>/), one image a batch from
data/loader.py::TrainLoader. Without it the driver runs on ``--synthetic N``
seeded images (4 if N is not given) with one to three ground-truth boxes
each, the same images in every stage (the JAX driver draws a fresh image
every step and dumps four), and stops after stage 3.
"""

from __future__ import annotations

import argparse
import itertools
import os
import pickle
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfg", required=True)
    p.add_argument("--synthetic", type=int, default=0,
                   help="run on N seeded synthetic images")
    p.add_argument("--steps", type=int, default=0,
                   help="steps of each training stage (default 10)")
    p.add_argument("--tiny", action="store_true",
                   help="the tiny trunk and 128x128 images")
    p.add_argument("--dataset-path", default="",
                   help="override cfg.dataset.dataset_path (COCO layout)")
    p.add_argument("--train-shared", action="store_true",
                   help="freeze network.FIXED_PARAMS_SHARED in the RCNN stage "
                        "(reference function/train_rcnn.py:119-123)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def synthetic_images(n: int, H: int, W: int, num_classes: int, max_gt: int,
                     seed: int = 0) -> list:
    """n seeded images: dicts of image [H, W, 3] (f32), im_info [3],
    gt_boxes [max_gt, 5], gt_valid [max_gt], and the roidb entry."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        g = rng.randint(1, 4)
        x1 = rng.uniform(0, W // 2, g)
        y1 = rng.uniform(0, H // 2, g)
        boxes = np.stack([x1, y1, x1 + rng.uniform(16, W // 3, g),
                          y1 + rng.uniform(16, H // 3, g)], 1).astype(np.float32)
        classes = rng.randint(1, num_classes, g)
        gt = np.zeros((max_gt, 5), np.float32)
        gt[:g, :4], gt[:g, 4] = boxes, classes
        gv = np.arange(max_gt) < g
        out.append({"image": rng.randn(H, W, 3).astype(np.float32),
                    "im_info": np.asarray([H, W, 1.0], np.float32),
                    "gt_boxes": gt, "gt_valid": gv,
                    "roidb": {"image": f"synthetic_{i}", "image_id": i,
                              "height": H, "width": W, "boxes": boxes,
                              "gt_classes": classes.astype(np.int32),
                              "iscrowd": np.zeros(g, bool), "flipped": False}})
    return out


def rcnn_batch(b: dict, proposals: np.ndarray, R: int) -> dict:
    """A one-image batch paired with its cached proposals [N, 5]: the first
    R, scaled to the network input, as ``rois`` [1, R, 4] and ``rois_valid``
    [1, R] (rcnn_batch of the JAX driver, experiments/rcnn_train_test.py)."""
    rois = np.zeros((1, R, 4), np.float32)
    n = min(len(proposals), R)
    rois[0, :n] = proposals[:n, :4] * float(b["im_info"][0][2])
    b.update(rois=rois, rois_valid=(np.arange(R) < n)[None])
    return b


def main(argv=None) -> dict:
    """Runs the workflow; returns the paths it wrote, the last metrics and,
    with a dataset, stage 4's results."""
    args = parse_args(argv)
    from relation_tpu_torch.config.defaults import load_config
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.checkpoint import save_checkpoint, save_params
    from relation_tpu_torch.core.rpn_workflow import (add_bbox_regression_stats,
                                                      evaluate_recall,
                                                      generate_rpn_proposals,
                                                      load_proposal_roidb,
                                                      make_train_step_rcnn,
                                                      make_train_step_rpn)
    from relation_tpu_torch.core.trainer import (build_model, create_train_state,
                                                 refreeze_state)
    from relation_tpu_torch.data.coco import coco_dataset, filter_roidb
    from relation_tpu_torch.data.loader import TrainLoader
    from relation_tpu_torch.utils.logging import Speedometer, create_logger

    cfg = load_config(args.cfg)
    if args.dataset_path:
        cfg.dataset.dataset_path = args.dataset_path
    synthetic = bool(args.synthetic) or not args.dataset_path
    cfg_name = os.path.splitext(os.path.basename(args.cfg))[0]
    logger, out_path = create_logger(cfg.output_path or "output", cfg_name,
                                     cfg.dataset.image_set)
    model = init_params(build_model(cfg, tiny=args.tiny, device=args.device),
                        seed=0)
    max_gt = int(cfg.TPU.MAX_GT)
    n_steps = args.steps or 10
    root = cfg.dataset.dataset_path
    if synthetic:
        H, W = (128, 128) if args.tiny else tuple(sorted(
            tuple(b) for b in cfg.TPU.IMAGE_BUCKETS)[0])
        images = synthetic_images(args.synthetic or 4, H, W,
                                  int(cfg.dataset.NUM_CLASSES), max_gt)
        roidb = [im["roidb"] for im in images]
        loader = [(i, im["image"], im["im_info"]) for i, im in enumerate(images)]

        def batch_of(i):
            im = images[i % len(images)]
            return {k: im[k][None] for k in ("image", "im_info", "gt_boxes",
                                              "gt_valid")}
        rpn_batches = (batch_of(i) for i in range(n_steps))
    else:
        roidb = filter_roidb(coco_dataset(root, cfg.dataset.image_set).roidb())
        loader = None                      # the TestLoader over the roidb
        one = TrainLoader(roidb, cfg, batch_size=1, num_prefetch=0)

        def batch_of(i):
            return one._make_batch([i % len(roidb)])

        def cycle():
            while True:
                yield from TrainLoader(roidb, cfg, batch_size=1)
        rpn_batches = itertools.islice(cycle(), n_steps)

    state = create_train_state(model, cfg, seed=0)
    logger.info("stage 1: RPN training")
    rpn_step = make_train_step_rpn(model, cfg, max_gt=max_gt, device=args.device)
    speedo = Speedometer(logger, 1, max(n_steps // 5, 1))
    for i, batch in enumerate(rpn_batches):
        state, m = rpn_step(state, batch)
        speedo.update(0, i, m)

    logger.info("stage 2: proposal generation")
    pkl = os.path.join(out_path, f"{cfg.dataset.image_set}_rpn.pkl")
    generate_rpn_proposals(model, cfg, roidb, pkl, loader=loader,
                           device=args.device)
    with open(pkl, "rb") as f:
        props = pickle.load(f)
    rec = evaluate_recall(roidb, props)
    logger.info("proposals -> %s; recall AR(all)=%.3f area-pct=%s" % (
        pkl, rec["ar"], {k: round(v, 3)
                         for k, v in rec["proposal_area_pct"].items()}))

    logger.info("stage 3: RCNN training on cached proposals")
    bbox_means = bbox_stds = None
    if not bool(cfg.TRAIN.BBOX_NORMALIZATION_PRECOMPUTED):
        prop_roidb = load_proposal_roidb(roidb, pkl,
                                         top_rois=int(cfg.TRAIN.TOP_ROIS))
        means_k, stds_k = add_bbox_regression_stats(
            prop_roidb, int(cfg.dataset.NUM_CLASSES), bool(cfg.CLASS_AGNOSTIC),
            float(cfg.TRAIN.BBOX_REGRESSION_THRESH))
        bbox_means, bbox_stds = means_k[1], stds_k[1]
        logger.info("roidb bbox stats: means=%s stds=%s"
                    % (np.round(bbox_means, 4), np.round(bbox_stds, 4)))
    if args.train_shared:
        # a fresh optimizer with FIXED_PARAMS_SHARED frozen (the reference's
        # RCNN stage binds a new Module, function/train_rcnn.py:119-136)
        state = refreeze_state(state, cfg, cfg.network.FIXED_PARAMS_SHARED)
        logger.info("stage 3 train_shared: frozen prefixes %s"
                    % list(cfg.network.FIXED_PARAMS_SHARED))
    R = max(max((len(p) for p in props), default=1), 8)
    rcnn_step = make_train_step_rcnn(model, cfg, max_rois=R, max_gt=max_gt,
                                     bbox_means=bbox_means, bbox_stds=bbox_stds,
                                     train_shared=args.train_shared,
                                     device=args.device)
    speedo = Speedometer(logger, 1, max(n_steps // 5, 1))
    for i in range(n_steps):
        state, m = rcnn_step(state, rcnn_batch(batch_of(i),
                                               props[i % len(props)], R))
        speedo.update(1, i, m)

    ckpt = save_checkpoint(os.path.join(out_path, "rcnn_alt-final.ckpt"), state)
    params = save_params(os.path.join(out_path, "rcnn_alt-final.params.msgpack"),
                         model)
    logger.info("alternate workflow done; total_loss=%.4f"
                % float(m["total_loss"]))
    out = {"proposals": pkl, "checkpoint": ckpt, "params": params,
           "metrics": {k: float(v) for k, v in m.items()}}

    # stage 4: the test set from its cached proposals (TEST.HAS_RPN false)
    if not synthetic:
        from relation_tpu_torch.core.evaluator import pred_eval_rcnn
        s_test = cfg.dataset.test_image_set
        test_ann = os.path.join(root, "annotations", f"instances_{s_test}.json")
        if os.path.exists(test_ann):
            test_ds = coco_dataset(root, s_test)
            test_roidb = test_ds.roidb()
            test_pkl = os.path.join(out_path, f"{s_test}_rpn.pkl")
            generate_rpn_proposals(model, cfg, test_roidb, test_pkl,
                                   device=args.device)
            results, dets = pred_eval_rcnn(
                model, cfg, test_ds, test_roidb, test_pkl, logger,
                cache_path=os.path.join(out_path, "detections.pkl"),
                ignore_cache=True)
            logger.info(f"stage 4 eval: {results}")
            out.update(test_proposals=test_pkl, results=results,
                       detections=dets)
        else:
            logger.info(f"no test annotations at {test_ann}; skipping stage 4")
    return out


if __name__ == "__main__":
    main()
