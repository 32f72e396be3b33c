"""Evaluation over a test set (port of relation_tpu/core/evaluator.py;
reference core/tester.py:163-342): the predictor over every image of a
loader, a detections cache (pickle), the results JSON, the data / net /
fetch / post timing split, then the COCO evaluation.

Differences from the JAX module, which the PyTorch route brings:
- the model holds its parameters: the functions take ``model``, not
  ``(model, params)``;
- one eager predict function serves every image bucket (no program is
  compiled a bucket), so ``prewarm_buckets`` makes one call a bucket in
  turn, to pay each bucket's first cuDNN call at each shape before the
  timed loop, where the JAX module compiles the buckets from threads;
- the counterpart of ``copy_to_host_async`` is a non-blocking copy into
  pinned host memory with a CUDA event, drained behind the window of
  TPU.EVAL_PIPELINE_DEPTH images in flight;
- a ``mesh`` of more than one device (data-parallel inference) is not
  ported: it raises NotImplementedError.
"""

from __future__ import annotations

import json
import os
import pickle
import time

import numpy as np
import torch

from relation_tpu_torch.core.predictor import (build_predict_fn,
                                               make_predict_fn_rcnn,
                                               prepare_res4_folded)
from relation_tpu_torch.data.eval import CocoEvaluator, format_coco_summary
from relation_tpu_torch.data.loader import ProposalTestLoader, TestLoader
from relation_tpu_torch.utils.native import have_native


def prewarm_buckets(predict, cfg, res4_folded=None, logger=None) -> float:
    """One call of ``predict`` (core/predictor.py::build_predict_fn, which
    takes any bucket) on a zero image of each bucket of TPU.IMAGE_BUCKETS,
    in turn, in the loader's layout (uint8 with TPU.H2D_UINT8, s2d planar
    with TPU.S2D_INPUT): the first cuDNN call at each shape is paid here
    instead of in the timed loop. Returns the seconds spent."""
    log = logger.info if logger else print
    dtype = np.uint8 if bool(cfg.TPU.get("H2D_UINT8", True)) else np.float32
    s2d = bool(cfg.TPU.get("S2D_INPUT", True))
    t0 = time.perf_counter()
    for H, W in (tuple(b) for b in cfg.TPU.IMAGE_BUCKETS):
        img = (np.zeros((12, H // 2, W // 2), dtype) if s2d
               else np.zeros((H, W, 3), dtype))
        try:
            out = predict(img, np.asarray([H, W, 1.0], np.float32), res4_folded)
            if out["dets"].is_cuda:
                torch.cuda.synchronize()
        except Exception as e:   # surfaces again on the real image
            log(f"prewarm bucket {(H, W)} failed: {e!r}")
    seconds = time.perf_counter() - t0
    log(f"prewarmed {len(cfg.TPU.IMAGE_BUCKETS)} buckets in {seconds:.1f}s")
    return seconds


class _HostCopy:
    """A result's detections on their way to the host: on the card, a
    non-blocking copy into pinned memory and the event after it; on the
    CPU, the tensor itself."""

    def __init__(self, dets: torch.Tensor):
        if dets.is_cuda:
            self.host = torch.empty(dets.shape, dtype=dets.dtype,
                                    pin_memory=True)
            self.host.copy_(dets, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = dets, None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def pred_eval(model, cfg, dataset, roidb, logger=None,
              cache_path: str | None = None, ignore_cache: bool = False,
              loader=None, proposal_file: str | None = None, mesh=None,
              stats: dict | None = None):
    """Returns (results dict, {image_id: dets [n, 6]}). roidb entries need
    image and image_id.

    With ``proposal_file`` the reference's TEST.HAS_RPN=false path runs:
    the head on cached proposals (function/test_rcnn.py:40-74) through
    ``ProposalTestLoader`` and ``make_predict_fn_rcnn``. ``loader`` replaces
    the loader built over ``roidb``. A dict ``stats`` is filled with the
    images, the seconds of data, net, fetch and post, summarize's seconds
    and the matching route (``native``: utils/native.py::have_native)."""
    log = logger.info if logger else print
    if mesh is not None and np.asarray(getattr(mesh, "devices", mesh)).size > 1:
        raise NotImplementedError(
            "data-parallel inference over a mesh of more than one device is "
            "not ported yet; pass mesh=None")
    timing = {"images": 0, "data_s": 0.0, "net_s": 0.0, "fetch_s": 0.0,
              "post_s": 0.0}
    if cache_path and os.path.exists(cache_path) and not ignore_cache:
        with open(cache_path, "rb") as f:
            dets_per_image = pickle.load(f)
        log(f"loaded detections cache: {cache_path}")
    else:
        dets_per_image = _run_loader(model, cfg, roidb, loader, proposal_file,
                                     timing, logger)
        if cache_path:
            os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
            with open(cache_path, "wb") as f:
                pickle.dump(dets_per_image, f)

    if cache_path:
        # detections_<set>_results.json beside the cache (reference
        # lib/dataset/coco.py:185-225 _write_coco_results)
        res_dir = os.path.join(os.path.dirname(cache_path) or ".", "results")
        os.makedirs(res_dir, exist_ok=True)
        image_set = getattr(cfg.dataset, "test_image_set", "test")
        res_file = os.path.join(res_dir, f"detections_{image_set}_results.json")
        with open(res_file, "w") as f:
            json.dump(dataset.detections_to_json(dets_per_image), f,
                      sort_keys=True)
        log(f"wrote results json: {res_file}")

    # reference tester.py:305-307: classes detected an image, and kept
    # detections over the fixed output slots
    if dets_per_image:
        n_img = len(dets_per_image)
        n_cls = sum(len(np.unique(d[:, 0])) for d in dets_per_image.values()
                    if len(d))
        n_det = sum(len(d) for d in dets_per_image.values())
        max_det = int(cfg.TEST.max_per_image)
        log(f"valid class ratio:{n_cls / n_img:.4f}")
        log(f"valid score ratio:{n_det / (max_det * n_img + 0.01):.4f}")

    t0 = time.perf_counter()
    evaluator = CocoEvaluator(dataset)
    for image_id, dets in dets_per_image.items():
        evaluator.add_detections(image_id, dets)
    results = evaluator.summarize()
    timing["summarize_s"] = time.perf_counter() - t0
    timing["native"] = have_native()
    log(f"summarize {timing['summarize_s']:.4f}s "
        f"({'native' if timing['native'] else 'NumPy'} matching)")
    # the per-category AP table and the 12-number COCOeval block
    # (lib/dataset/coco.py:262-282 + cocoeval.summarize)
    for line in format_coco_summary(
            results, getattr(dataset, "class_names", None)).splitlines():
        log(line)
    if stats is not None:
        stats.update(timing)
    return results, dets_per_image


def _run_loader(model, cfg, roidb, loader, proposal_file, timing,
                logger) -> dict:
    """The predictor over ``loader`` with a window of
    TPU.EVAL_PIPELINE_DEPTH results in flight; fills ``timing``."""
    log = logger.info if logger else print
    if proposal_file:
        loader = loader or ProposalTestLoader(roidb, cfg, proposal_file)
        predict_rcnn = make_predict_fn_rcnn(model, cfg)
    else:
        loader = loader or TestLoader(roidb, cfg)
        predict = build_predict_fn(model, cfg)
    # once a checkpoint: the BN-folded res4 stacks (None unless
    # TPU.FUSE_RES4)
    res4_folded = prepare_res4_folded(
        model, enabled=bool(cfg.TPU.get("FUSE_RES4", False)))
    buckets = cfg.TPU.IMAGE_BUCKETS
    if (not proposal_file and roidb is not None
            and bool(cfg.TPU.get("PREWARM_BUCKETS", True))
            and len(roidb) >= 8 * len(buckets) and len(buckets) > 1):
        prewarm_buckets(predict, cfg, res4_folded, logger)

    dets_per_image = {}
    window: list[tuple] = []
    depth = int(cfg.TPU.get("EVAL_PIPELINE_DEPTH", 8))
    log_every = int(cfg.TPU.get("EVAL_LOG_EVERY", 200))

    def drain(entry):
        # the wait for the copy is fetch, not net: data / net / post keep
        # the reference's meaning (core/tester.py:283-295)
        image_id, pending = entry
        t0 = time.perf_counter()
        dets = pending.numpy()
        t1 = time.perf_counter()
        timing["fetch_s"] += t1 - t0
        dets_per_image[image_id] = dets[dets[:, 0] >= 0]
        timing["post_s"] += time.perf_counter() - t1

    n = 0
    t = time.perf_counter()
    for n, item in enumerate(loader, 1):
        image_id, img, im_info = item[:3]
        timing["data_s"] += time.perf_counter() - t
        t = time.perf_counter()
        if proposal_file:
            out = predict_rcnn(img, im_info, item[3], item[4])
        else:
            out = predict(img, im_info, res4_folded)
        if "monitor" in out:
            # --debug taps, read at once (debug trades speed for the view,
            # as the reference's monitor callback does)
            for name, s in out["monitor"].items():
                s = s.cpu().numpy()
                log(f"[monitor] image {image_id} {name}: min={s[0]:.5f} "
                    f"max={s[1]:.5f} mean={s[2]:.5f}")
        window.append((image_id, _HostCopy(out["dets"])))
        timing["net_s"] += time.perf_counter() - t
        if len(window) >= depth:
            drain(window.pop(0))
        if n % log_every == 0:
            log(f"{n}/{len(loader)} " + _split(timing, n))
        t = time.perf_counter()
    for entry in window:
        drain(entry)
    timing["images"] = n
    if n:
        log(f"{n} images: " + _split(timing, n))
    return dets_per_image


def _split(timing: dict, n: int) -> str:
    return " ".join(f"{k} {timing[k + '_s'] / n:.4f}s"
                    for k in ("data", "net", "fetch", "post"))


def pred_eval_rcnn(model, cfg, dataset, roidb, proposal_file: str,
                   logger=None, cache_path: str | None = None,
                   ignore_cache: bool = False, loader=None,
                   stats: dict | None = None):
    """Cached-proposal evaluation (reference function/test_rcnn.py)."""
    return pred_eval(model, cfg, dataset, roidb, logger,
                     cache_path=cache_path, ignore_cache=ignore_cache,
                     loader=loader, proposal_file=proposal_file, stats=stats)
