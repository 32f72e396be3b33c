"""Where the time of the port's inference (or, with --train, of its train
step) goes, on one CUDA card.

    python3 -m relation_tpu_torch.tools.profile_flagship [--family flagship]
        [--requests 3] [--trace out.json] [--train | --workflow]

Builds one family of relation_tpu_torch/entry.py::FAMILIES (the flagship,
dcn, dcn_relation, dcn_learn_nms, fpn, fpn_relation or fpn_learn_nms;
weights from init_params(seed=0), a DCN family's offset branches seeded away
from zero and an FPN family's prediction layers calibrated, as chip_smoke.py
does) on cuda:0, serves it through core/predictor.py::build_predict_fn (the
split form for fpn_learn_nms), warms up, then:

1. stage split: host clock with torch.cuda.synchronize() around each stage
   of one seeded 608x1024 request, median over --requests: for a C4 family
   C4 trunk + RPN head, res5 + conv_new_1, proposals, ROI head, tail
   (learned NMS or classic NMS with the detection cut); for an FPN family
   trunk + res5 + neck + RPN over five levels, proposals, ROI head (4-level
   pool, FCs, relations), tail;
2. torch.profiler over --requests whole requests: device busy time (the
   sum of kernel times, overlaps merged) against the window's wall time,
   so the idle share, and the kernels ranked by device time;
3. for a DCN family, the deformable ops alone at full width with CUDA
   events: the deformable conv of res5 (512 channels, 38x64, 4 groups,
   bf16) forward and backward at B=1 and B=2, and the deformable PSROI pool
   (300 ROIs, 7x7, 4 samples a part, 256 channels) without and with trans,
   forward and backward.

With --workflow it profiles fpn_learn_nms's alternate workflow instead
(chip_smoke.py's phase 12): --requests RCNN steps on 1000 cached ROIs and
--requests predict_rcnn calls, each with the same report.

With --train it profiles --requests train steps instead (B=2, the batch and
the clip of chip_smoke.py's training phase, after two warm-up steps; any
family, an FPN one calibrated as above): wall time, device busy time, idle
share, the operations ranked by device time and by host time, and the
indexing operations (index_put and the like, forward and backward).

Prints the card's name and power limit first. Needs a CUDA card and
chip_smoke.py beside the package (its seeding and timing helpers).
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np


def time_deformable_ops(torch, dev, time_ms):
    from relation_tpu_torch.ops.deform import (deformable_conv_batched,
                                               deformable_psroi_pool)
    rng = np.random.RandomState(0)
    H, W, C, G = 38, 64, 512, 4
    for B in (1, 2):
        x = torch.tensor(rng.randn(B, H, W, C), dtype=torch.bfloat16, device=dev)
        w = torch.tensor(rng.randn(3, 3, C, C) * 0.02, dtype=torch.bfloat16,
                         device=dev)
        off = torch.tensor(rng.randn(B, H, W, G * 18), dtype=torch.float32,
                           device=dev)
        ins = [a.requires_grad_(True) for a in (x, off, w)]
        with torch.no_grad():
            fwd = time_ms(torch, lambda: deformable_conv_batched(
                x, off, w, kernel=3, dilation=2, num_groups=G))
        out = deformable_conv_batched(*ins, kernel=3, dilation=2, num_groups=G)
        g = torch.randn_like(out)
        bwd = time_ms(torch, lambda: torch.autograd.grad(out, ins, g,
                                                         retain_graph=True))
        print(f"deformable conv res5 B={B} bf16: forward {fwd:.4f} ms, backward "
              f"(dcol, dw, col2im kernel, offset gradient) {bwd:.4f} ms")
    feat = torch.tensor(rng.randn(H, W, 256), dtype=torch.bfloat16, device=dev)
    xy = rng.uniform(0, [900, 500], (300, 2))
    rois = torch.tensor(np.concatenate([xy, xy + rng.uniform(16, 400, (300, 2))], 1),
                        dtype=torch.float32, device=dev)
    trans = torch.tensor(rng.randn(300, 2, 7, 7), dtype=torch.float32, device=dev)
    for name, tr in (("no trans", None), ("trans", trans)):
        with torch.no_grad():
            fwd = time_ms(torch, lambda: deformable_psroi_pool(
                feat, rois, tr, 1 / 16, pooled_size=7, sample_per_part=4))
        f = feat.clone().requires_grad_(True)
        ins = [f] if tr is None else [f, tr.clone().requires_grad_(True)]
        out = deformable_psroi_pool(f, rois, None if tr is None else ins[1], 1 / 16,
                                    pooled_size=7, sample_per_part=4)
        g = torch.randn_like(out)
        bwd = time_ms(torch, lambda: torch.autograd.grad(out, ins, g,
                                                         retain_graph=True))
        print(f"deformable PSROI pool 300 rois bf16, {name}: forward {fwd:.4f} ms, "
              f"backward {bwd:.4f} ms")


def device_busy_us(torch, prof) -> tuple[float, int]:
    """(device busy us with overlaps merged, number of device ops)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, len(spans)


def report(torch, prof, wall_us: float, n: int, unit: str) -> None:
    busy, n_ops = device_busy_us(torch, prof)
    print(f"profiled {n} {unit}s: wall {wall_us / 1e3:.3f} ms, device "
          f"busy {busy / 1e3:.3f} ms, idle share {1 - busy / wall_us:.3f}, "
          f"{n_ops / n:.0f} device ops per {unit}")
    rows = sorted(prof.key_averages(), key=lambda r: -r.self_device_time_total)
    print(f"top device time per {unit} (us): " + "; ".join(
        f"{r.key[:60]} {r.self_device_time_total / n:.1f} (x{r.count // n})"
        for r in rows[:15] if r.self_device_time_total > 0))


def profile_training(torch, dev, family: str, steps: int, trace: str) -> None:
    from chip_smoke import calibrate_heads, seed_offsets, training_batch
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.predictor import build_predict_fn
    from relation_tpu_torch.core.trainer import (build_model, create_train_state,
                                                 make_train_step)
    from relation_tpu_torch.entry import BUCKET, family_cfg
    from torch.profiler import ProfilerActivity, profile
    cfg = family_cfg(family)
    cfg.TPU.GRAD_CLIP = 10.0
    batch = training_batch(*BUCKET)
    model = init_params(build_model(cfg, device=dev), seed=0)
    if family.startswith("fpn"):
        calibrate_heads(torch, model, build_predict_fn(model, cfg),
                        torch.tensor(batch["image"][0], device=dev),
                        torch.tensor(batch["im_info"][0], device=dev))
    elif model.dcn:
        seed_offsets(torch, model, cfg, batch["image"][0], batch["im_info"][0])
    state = create_train_state(model, cfg, seed=0)
    step = make_train_step(model, cfg, device=dev)
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if trace:
        prof.export_chrome_trace(trace)
    print(f"{family} train step, B={batch['image'].shape[0]}")
    report(torch, prof, wall_us, steps, "step")
    rows = sorted(prof.key_averages(), key=lambda r: -r.self_cpu_time_total)
    print("top host time per step (us): " + "; ".join(
        f"{r.key[:60]} {r.self_cpu_time_total / steps:.1f} (x{r.count // steps})"
        for r in rows[:12]))
    # the indexing ops and their backward (the FPN head's pooled ROIs are put
    # back in their order with an index_put)
    print("indexing ops per step (us, device / host): " + "; ".join(
        f"{r.key[:60]} {r.self_device_time_total / steps:.1f} / "
        f"{r.self_cpu_time_total / steps:.1f} (x{r.count // steps})"
        for r in rows if "index" in r.key.lower()))


def profile_workflow(torch, dev, steps: int, trace: str) -> None:
    """fpn_learn_nms through the alternate workflow, set up by chip_smoke.py's
    phase 12 (``workflow_setup``: calibrated, the three seeded images; the
    proposal dump's 1000 best ROIs an image, ``cached_rois``; train_shared,
    the clip): ``steps`` RCNN steps and ``steps`` predict_rcnn calls on
    image 0, each kind after two warm-up calls, each profiled on its own."""
    import tempfile
    from chip_smoke import cached_rois, workflow_batch, workflow_setup
    from relation_tpu_torch.core.predictor import make_predict_fn_rcnn
    from relation_tpu_torch.core.rpn_workflow import (generate_rpn_proposals,
                                                      load_proposal_roidb,
                                                      make_train_step_rcnn)
    from relation_tpu_torch.core.trainer import create_train_state, refreeze_state
    from torch.profiler import ProfilerActivity, profile
    cfg, data, items, roidb, model = workflow_setup(torch, dev)
    R = int(cfg.TRAIN.TOP_ROIS)
    with tempfile.TemporaryDirectory() as tmp:
        pkl = os.path.join(tmp, "rpn.pkl")
        generate_rpn_proposals(model, cfg, roidb, pkl, loader=items, device=dev)
        rois, valid = cached_rois(load_proposal_roidb(roidb, pkl, R), data, 0, R)
    batch = workflow_batch(data, 0, rois=rois, rois_valid=valid)
    state = refreeze_state(create_train_state(model, cfg, seed=0), cfg,
                           cfg.network.FIXED_PARAMS_SHARED)
    step = make_train_step_rcnn(model, cfg, max_rois=R,
                                max_gt=data["gt_boxes"].shape[1],
                                train_shared=True, device=dev)
    predict = make_predict_fn_rcnn(model, cfg)
    image, info = items[0][1], items[0][2]
    for unit, call in (("RCNN step", lambda: step(state, batch)),
                       ("predict_rcnn call",
                        lambda: predict(image, info, rois, valid))):
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                call()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        if trace:
            prof.export_chrome_trace(f"{trace}.{unit.split()[0]}.json")
        print(f"fpn_learn_nms alternate workflow, {unit}, {int(valid.sum())} "
              f"cached ROIs")
        report(torch, prof, wall_us, steps, unit.split()[-1])
        rows = sorted(prof.key_averages(), key=lambda r: -r.self_cpu_time_total)
        print(f"top host time per {unit.split()[-1]} (us): " + "; ".join(
            f"{r.key[:60]} {r.self_cpu_time_total / steps:.1f} "
            f"(x{r.count // steps})" for r in rows[:12]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="flagship")
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--trace", default="")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--workflow", action="store_true")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    from chip_smoke import calibrate_heads, seed_offsets, time_ms
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.predictor import build_predict_fn
    from relation_tpu_torch.core.trainer import build_model
    from relation_tpu_torch.entry import BUCKET, family_cfg
    from relation_tpu_torch.models.fpn import (FPN_STRIDES, RelationRCNNFPN,
                                               generate_proposals_fpn)
    from relation_tpu_torch.models.rpn import generate_proposals
    from relation_tpu_torch.ops.anchors import generate_anchors

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    if args.train:
        profile_training(torch, dev, args.family, args.requests, args.trace)
        return
    if args.workflow:
        profile_workflow(torch, dev, args.requests, args.trace)
        return
    cfg = family_cfg(args.family)
    model = init_params(build_model(cfg, device=dev), seed=0)
    H, W = BUCKET
    image = torch.tensor(np.random.RandomState(7).randn(12, H // 2, W // 2) * 40.0,
                         dtype=torch.float32, device=dev)
    im_info = torch.tensor([600.0, 1000.0, 1.667], device=dev)
    fpn = isinstance(model, RelationRCNNFPN)
    predict = build_predict_fn(model, cfg)
    if fpn:
        calibrate_heads(torch, model, predict, image, im_info)
    elif model.dcn:
        seed_offsets(torch, model, cfg, image, im_info)
    net, test = cfg.network, cfg.TEST
    stride = int(net.RPN_FEAT_STRIDE)
    ratios, scales = tuple(net.ANCHOR_RATIOS), tuple(net.ANCHOR_SCALES)
    anchors = torch.tensor(generate_anchors(stride, ratios, scales),
                           dtype=torch.float32, device=dev)
    level_anchors = {s: torch.tensor(generate_anchors(s, ratios, scales),
                                     dtype=torch.float32, device=dev)
                     for s in FPN_STRIDES}
    proposal_args = (int(test.RPN_PRE_NMS_TOP_N), int(test.RPN_POST_NMS_TOP_N),
                     float(test.RPN_NMS_THRESH), float(test.RPN_MIN_SIZE))
    for _ in range(2):
        predict(image, im_info)
    torch.cuda.synchronize()

    names = (("trunk+c5+neck+rpn", "proposals", "head", "tail") if fpn else
             ("c4+rpn", "res5", "proposals", "head", "tail"))
    stages = {k: [] for k in names + ("total",)}
    with torch.inference_mode():
        for _ in range(args.requests):
            t = [time.perf_counter()]

            def mark():
                torch.cuda.synchronize()
                t.append(time.perf_counter())
            if fpn:
                feat, rpn_out = model.features_and_rpn(image)
                mark()
                rois, _, roi_real = generate_proposals_fpn(
                    rpn_out, level_anchors, im_info, *proposal_args)
                mark()
            else:
                c4 = model.c4(image[None])
                rpn_cls, rpn_bbox = model.rpn(c4)
                mark()
                feat = F.relu(model.conv_new_1(model.c5(c4))).permute(0, 2, 3, 1)[0]
                mark()
                rois, _, roi_real = generate_proposals(
                    torch.softmax(rpn_cls[0], -1)[..., 1], rpn_bbox[0], anchors,
                    im_info, stride, *proposal_args)
                mark()
            cls_score, bbox_pred, fc2 = model.head(
                feat, rois, int(test.RPN_POST_NMS_TOP_N))
            mark()
            predict.tail(cls_score, bbox_pred, fc2, rois, roi_real, im_info)
            mark()
            for k, (a, b) in zip(stages, zip(t[:-1], t[1:])):
                stages[k].append((b - a) * 1e3)
            stages["total"].append((t[-1] - t[0]) * 1e3)
    print("%s stage split, host clock ms (median of %d): %s" % (
        args.family, args.requests, "; ".join(
            f"{k} {statistics.median(v):.3f}" for k, v in stages.items())))

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.requests):
            predict(image, im_info)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if args.trace:
        prof.export_chrome_trace(args.trace)
    report(torch, prof, wall_us, args.requests, "request")
    if not fpn and model.dcn:
        time_deformable_ops(torch, dev, time_ms)


if __name__ == "__main__":
    main()
