"""End-to-end training driver of the port (counterpart of
experiments/train.py; reference relation_rcnn/train_end2end.py).

    python -m relation_tpu_torch.experiments.train --cfg experiments/cfgs/<name>.yaml \\
        [--synthetic N] [--steps K] [--tiny] [--device cpu]

Reads the COCO-layout dataset under cfg.dataset.dataset_path:
annotations/instances_<set>.json and images/<set>/ for each '+'-joined set of
cfg.dataset.image_set, flipped copies appended with TRAIN.FLIP, images
without a non-crowd box dropped, batches of TRAIN.BATCH_IMAGES images from
data/loader.py::TrainLoader. Weights start from ``init_params(model,
seed=0)``. After each epoch it writes the checkpoint and the params file
(core/checkpoint.py, the JAX package's format) as
<output_path>/<cfg>/<image_set>/<model_prefix>-EEEE.{ckpt,params.msgpack};
TRAIN.RESUME restarts from TRAIN.begin_epoch's checkpoint. ``--steps K``
stops after K steps and saves that epoch. ``--synthetic N`` trains on N
seeded random images instead of a dataset. One device; a mesh of several is
not ported. ``--dataset-path`` is tolerated and ignored, as in the JAX
driver: the dataset is cfg.dataset.dataset_path.
"""

from __future__ import annotations

import argparse
import os
import pprint
import shutil
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train Relation R-CNN (PyTorch)")
    p.add_argument("--cfg", required=True)
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic images instead of COCO")
    p.add_argument("--steps", type=int, default=0,
                   help="cap total optimizer steps (0 = full schedule)")
    p.add_argument("--tiny", action="store_true", help="tiny backbone (debug)")
    p.add_argument("--device", default="cuda")
    # the sibling driver's flags only (rcnn_end2end_train_test.py forwards
    # one argv to both drivers); anything else is an error
    for flag in ("--ckpt", "--test-set", "--dataset-path"):
        p.add_argument(flag, default="", help=argparse.SUPPRESS)
    p.add_argument("--thresh", type=float, default=0.0, help=argparse.SUPPRESS)
    p.add_argument("--nms", type=float, default=0.0, help=argparse.SUPPRESS)
    for flag in ("--softnms", "--naive-nms", "--ignore-cache", "--vis"):
        p.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--first-n", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--merge", type=int, default=-10, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def train_roidb(cfg) -> list:
    """The filtered roidb of every '+'-joined set of cfg.dataset.image_set,
    with flipped copies when TRAIN.FLIP."""
    from relation_tpu_torch.data.coco import coco_dataset, filter_roidb
    roidb = []
    for s in cfg.dataset.image_set.split("+"):
        roidb += coco_dataset(cfg.dataset.dataset_path, s).roidb(
            flip=bool(cfg.TRAIN.FLIP))
    return filter_roidb(roidb)


def synthetic_batches(cfg, n: int, batch_size: int, tiny: bool):
    """An epoch of ``n // batch_size`` seeded batches of random f32 NHWC
    images with one to four boxes each (the JAX driver's --synthetic)."""
    H, W = (128, 128) if tiny else tuple(cfg.TPU.IMAGE_BUCKETS[0])
    max_gt = int(cfg.TPU.MAX_GT)
    rng = np.random.RandomState(0)

    def batches():
        for _ in range(max(n // batch_size, 1)):
            gt = np.zeros((batch_size, max_gt, 5), np.float32)
            gv = np.zeros((batch_size, max_gt), bool)
            for b in range(batch_size):
                g = rng.randint(1, 5)
                for i in range(g):
                    x1, y1 = rng.uniform(0, W // 2), rng.uniform(0, H // 2)
                    gt[b, i] = [x1, y1, x1 + rng.uniform(16, W // 3),
                                y1 + rng.uniform(16, H // 3),
                                rng.randint(1, cfg.dataset.NUM_CLASSES)]
                gv[b, :g] = True
            yield {"image": rng.randn(batch_size, H, W, 3).astype(np.float32),
                   "im_info": np.tile(np.asarray([[H, W, 1.0]], np.float32),
                                      (batch_size, 1)),
                   "gt_boxes": gt, "gt_valid": gv}
    return batches, max(n // batch_size, 1)


def main(argv=None, image_loader=None) -> dict:
    """Trains; returns the model, the train state, the files of the last
    epoch, the last metrics and the seconds of each step (``data_s``: the
    wait for the batch, ``step_s``: the step to its metrics on the host),
    and of the last save. ``image_loader`` replaces the loader's file
    decode (data/loader.py::TrainLoader)."""
    args = parse_args(argv)
    import torch
    from relation_tpu_torch.config.defaults import load_config
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.checkpoint import (restore_checkpoint,
                                                    save_checkpoint, save_params)
    from relation_tpu_torch.core.trainer import (build_model, create_train_state,
                                                 make_train_step)
    from relation_tpu_torch.data.loader import TrainLoader
    from relation_tpu_torch.utils.compile_cache import enable_from_env_or_cfg
    from relation_tpu_torch.utils.logging import Speedometer, create_logger

    cfg = load_config(args.cfg)
    enable_from_env_or_cfg(cfg)
    cfg_name = os.path.splitext(os.path.basename(args.cfg))[0]
    logger, out_path = create_logger(cfg.output_path or "output", cfg_name,
                                     cfg.dataset.image_set)
    logger.info(f"config: {args.cfg}")
    # reference train_end2end.py:64,74-75: the config beside the run's
    # outputs and in the log
    try:
        shutil.copy2(args.cfg, out_path)
    except (OSError, shutil.SameFileError):
        pass
    logger.info("training config:\n" + pprint.pformat(cfg))

    np.random.seed(0)
    model = init_params(build_model(cfg, tiny=args.tiny, device=args.device),
                        seed=0)
    batch_size = int(cfg.TRAIN.BATCH_IMAGES)
    if args.synthetic:
        batches, epoch_size = synthetic_batches(cfg, args.synthetic, batch_size,
                                                args.tiny)
    else:
        roidb = train_roidb(cfg)
        logger.info(f"roidb size: {len(roidb)}")
        kw = {} if image_loader is None else {"image_loader": image_loader}
        loader = TrainLoader(roidb, cfg, batch_size, **kw)
        epoch_size = len(loader)

        def batches():
            yield from loader

    state = create_train_state(model, cfg, seed=0, epoch_size=epoch_size)
    model_prefix = os.path.join(out_path, cfg.TRAIN.model_prefix or "model")
    begin_epoch = int(cfg.TRAIN.begin_epoch)
    if cfg.TRAIN.RESUME:
        ckpt = f"{model_prefix}-{begin_epoch:04d}.ckpt"
        state = restore_checkpoint(ckpt, state)
        logger.info(f"resumed from {ckpt}")

    step = make_train_step(model, cfg, device=args.device)
    speedo = Speedometer(logger, batch_size, int(cfg.default.frequent))
    data_s, step_s, metrics, files, save_s = [], [], {}, {}, 0.0
    for epoch in range(begin_epoch, int(cfg.TRAIN.end_epoch)):
        t = time.perf_counter()
        for i, batch in enumerate(batches()):
            t1 = time.perf_counter()
            state, m = step(state, batch)
            metrics = {k: float(v) for k, v in m.items()}
            t2 = time.perf_counter()
            data_s.append(t1 - t)
            step_s.append(t2 - t1)
            speedo.update(epoch, i, metrics)
            t = time.perf_counter()
            if args.steps and len(step_s) >= args.steps:
                break
        # the resume blob and the params-only file of the eval path (the
        # reference's module_checkpoint + do_checkpoint, train_end2end.py:
        # 151-152)
        t = time.perf_counter()
        files = {"checkpoint": save_checkpoint(
                     f"{model_prefix}-{epoch + 1:04d}.ckpt", state),
                 "params": save_params(
                     f"{model_prefix}-{epoch + 1:04d}.params.msgpack", model)}
        save_s = time.perf_counter() - t
        logger.info(f"saved checkpoint epoch {epoch + 1}")
        if args.steps and len(step_s) >= args.steps:
            break
    logger.info("training done")
    if torch.cuda.is_available() and next(model.parameters()).is_cuda:
        torch.cuda.synchronize()
    return {"model": model, "state": state, "cfg": cfg, "metrics": metrics,
            "data_s": data_s, "step_s": step_s, "save_s": save_s, **files}


if __name__ == "__main__":
    main()
