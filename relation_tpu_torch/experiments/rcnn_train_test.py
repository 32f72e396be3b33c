"""The alternate-workflow driver of the port (counterpart of
experiments/rcnn_train_test.py):

  1. train the RPN alone (core/rpn_workflow.py::make_train_step_rpn);
  2. dump its proposals over the training images (<image_set>_rpn.pkl) and
     report their recall;
  3. train the RCNN head on the cached proposals (TRAIN.TOP_ROIS of them an
     image), with the bbox-target statistics of the roidb when
     TRAIN.BBOX_NORMALIZATION_PRECOMPUTED is false; ``--train-shared``
     freezes network.FIXED_PARAMS_SHARED;
  4. save the checkpoint and the params file (core/checkpoint.py, the JAX
     package's format) under <output_path>/<cfg>/<image_set>/.

    python -m relation_tpu_torch.experiments.rcnn_train_test \\
        --cfg experiments/cfgs/<fpn cfg>.yaml --synthetic 2 --steps 2 \\
        [--tiny] [--train-shared] [--device cpu]

``--synthetic N`` runs on N seeded images with one to three ground-truth
boxes each, the same images in every stage (the JAX driver draws a fresh
image every step and dumps four). A dataset (``--dataset-path``) and the
evaluation from the proposal file need the data loaders and the evaluator,
which are not ported yet: they raise NotImplementedError.
"""

from __future__ import annotations

import argparse
import os
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
                   help="a COCO-layout dataset (not ported yet)")
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


def main(argv=None) -> dict:
    """Runs the workflow; returns the paths it wrote and the last metrics."""
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
    from relation_tpu_torch.utils.logging import Speedometer, create_logger

    if args.dataset_path or not args.synthetic:
        raise NotImplementedError(
            "training on a dataset needs the data loaders and stage 4 the "
            "evaluator, which are not ported yet; run with --synthetic N")
    cfg = load_config(args.cfg)
    cfg_name = os.path.splitext(os.path.basename(args.cfg))[0]
    logger, out_path = create_logger(cfg.output_path or "output", cfg_name,
                                     cfg.dataset.image_set)
    model = init_params(build_model(cfg, tiny=args.tiny, device=args.device),
                        seed=0)
    max_gt = int(cfg.TPU.MAX_GT)
    n_steps = args.steps or 10
    H, W = (128, 128) if args.tiny else tuple(sorted(
        tuple(b) for b in cfg.TPU.IMAGE_BUCKETS)[0])
    images = synthetic_images(args.synthetic, H, W, int(cfg.dataset.NUM_CLASSES),
                              max_gt)
    roidb = [im["roidb"] for im in images]

    def batch_of(i, **extra):
        im = images[i % len(images)]
        b = {k: im[k][None] for k in ("image", "im_info", "gt_boxes", "gt_valid")}
        b.update({k: v[None] for k, v in extra.items()})
        return b

    state = create_train_state(model, cfg, seed=0)
    logger.info("stage 1: RPN training")
    rpn_step = make_train_step_rpn(model, cfg, max_gt=max_gt, device=args.device)
    speedo = Speedometer(logger, 1, max(n_steps // 5, 1))
    for i in range(n_steps):
        state, m = rpn_step(state, batch_of(i))
        speedo.update(0, i, m)

    logger.info("stage 2: proposal generation")
    pkl = os.path.join(out_path, f"{cfg.dataset.image_set}_rpn.pkl")
    generate_rpn_proposals(
        model, cfg, roidb, pkl, device=args.device,
        loader=[(i, im["image"], im["im_info"]) for i, im in enumerate(images)])
    top_rois = int(cfg.TRAIN.TOP_ROIS)
    prop_roidb = load_proposal_roidb(roidb, pkl, top_rois=top_rois)
    rec = evaluate_recall(prop_roidb, [np.concatenate(
        [e["proposals"], np.zeros((len(e["proposals"]), 1), np.float32)], 1)
        for e in prop_roidb])
    logger.info("proposals -> %s; recall AR(all)=%.3f area-pct=%s" % (
        pkl, rec["ar"], {k: round(v, 3)
                         for k, v in rec["proposal_area_pct"].items()}))

    logger.info("stage 3: RCNN training on cached proposals")
    bbox_means = bbox_stds = None
    if not bool(cfg.TRAIN.BBOX_NORMALIZATION_PRECOMPUTED):
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
    R = max(max((len(e["proposals"]) for e in prop_roidb), default=1), 8)
    rcnn_step = make_train_step_rcnn(model, cfg, max_rois=R, max_gt=max_gt,
                                     bbox_means=bbox_means, bbox_stds=bbox_stds,
                                     train_shared=args.train_shared,
                                     device=args.device)
    speedo = Speedometer(logger, 1, max(n_steps // 5, 1))
    for i in range(n_steps):
        props = prop_roidb[i % len(prop_roidb)]["proposals"]
        scale = float(images[i % len(images)]["im_info"][2])
        rois = np.zeros((R, 4), np.float32)
        rois[:len(props)] = props * scale
        state, m = rcnn_step(state, batch_of(
            i, rois=rois, rois_valid=np.arange(R) < len(props)))
        speedo.update(1, i, m)

    ckpt = save_checkpoint(os.path.join(out_path, "rcnn_alt-final.ckpt"), state)
    params = save_params(os.path.join(out_path, "rcnn_alt-final.params.msgpack"),
                         model)
    logger.info("alternate workflow done; total_loss=%.4f"
                % float(m["total_loss"]))
    return {"proposals": pkl, "checkpoint": ckpt, "params": params,
            "metrics": {k: float(v) for k, v in m.items()}}


if __name__ == "__main__":
    main()
