"""Where the time of the port's inference (or, with --train, of its train
step) goes, on one CUDA card.

    python3 -m relation_tpu_torch.tools.profile_flagship [--family flagship]
        [--requests 3] [--trace out.json] [--train | --workflow]

Builds one family of relation_tpu_torch/entry.py::FAMILIES (the flagship,
dcn, dcn_relation, dcn_learn_nms, fpn, fpn_relation or fpn_learn_nms;
weights from init_params(seed=0), a DCN family's offset branches seeded away
from zero and an FPN family's prediction layers calibrated, by
tools/calibrate.py) on cuda:0, serves it through
core/predictor.py::build_predict_fn (the split form for fpn_learn_nms),
warms up, then:

1. torch.profiler over --requests whole seeded 608x1024 requests: device
   busy time (the sum of kernel times, overlaps merged) against the
   window's wall time, so the idle share; the program's stage spans
   (utils/trace.py, enabled here: predict.input, predict.trunk_rpn,
   predict.proposals, predict.head, predict.tail) with their calls and
   host time a request and the device time of the kernels launched under
   each; and the kernels ranked by device time;
2. for a DCN family, the deformable ops alone at full width with CUDA
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
share, the program's stage spans (step.input, step.trunk_rpn, step.rois,
step.backward, step.update; a span's device time leaves out the backward's
kernels, which autograd's own thread launches), the operations ranked by
device time and by host time, and the indexing operations (index_put and
the like, forward and backward).

Prints the card's name and power limit first. Needs a CUDA card and
chip_smoke.py beside the package (its batches and timing helpers).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

from relation_tpu_torch.utils import trace


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
    """(device busy us with overlaps merged, number of device ops); the
    program spans' copies on the device's timeline are no device work."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith(trace.PREFIX))
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
    """The profiled window: device busy time and idle share, the program's
    spans (utils/trace.py, reset before the window) with the device time
    of the kernels each launched on its own thread, and the top device
    operations."""
    busy, n_ops = device_busy_us(torch, prof)
    print(f"profiled {n} {unit}s: wall {wall_us / 1e3:.3f} ms, device "
          f"busy {busy / 1e3:.3f} ms, idle share {1 - busy / wall_us:.3f}, "
          f"{n_ops / n:.0f} device ops per {unit}")
    dev = {}
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                and e.name.startswith(trace.PREFIX)):
            name = e.name[len(trace.PREFIX):]
            dev[name] = dev.get(name, 0.0) + e.device_time_total
    print(f"program spans per {unit} (calls, host ms, device ms): " + "; ".join(
        f"{k} {v['count'] / n:g}, {1e3 * v['total_s'] / n:.3f}, "
        f"{dev.get(k, 0.0) / 1e3 / n:.3f}"
        for k, v in trace.snapshot()["spans"].items()))
    # the spans' copies on the device's timeline are no device work
    rows = sorted((r for r in prof.key_averages()
                   if not r.key.startswith(trace.PREFIX)),
                  key=lambda r: -r.self_device_time_total)
    print(f"top device time per {unit} (us): " + "; ".join(
        f"{r.key[:60]} {r.self_device_time_total / n:.1f} (x{r.count // n})"
        for r in rows[:15] if r.self_device_time_total > 0))


def profile_training(torch, dev, family: str, steps: int,
                     trace_file: str) -> None:
    from chip_smoke import training_batch
    from relation_tpu_torch.tools.calibrate import calibrate_heads, seed_offsets
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
        calibrate_heads(model, build_predict_fn(model, cfg),
                        torch.tensor(batch["image"][0], device=dev),
                        torch.tensor(batch["im_info"][0], device=dev))
    elif model.dcn:
        seed_offsets(model, cfg, batch["image"][0], batch["im_info"][0])
    state = create_train_state(model, cfg, seed=0)
    step = make_train_step(model, cfg, device=dev)
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if trace_file:
        prof.export_chrome_trace(trace_file)
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


def profile_workflow(torch, dev, steps: int, trace_file: str) -> None:
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
        trace.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                call()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        if trace_file:
            prof.export_chrome_trace(f"{trace_file}.{unit.split()[0]}.json")
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
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    from chip_smoke import time_ms
    from relation_tpu_torch.tools.calibrate import calibrate_heads, seed_offsets
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.predictor import build_predict_fn
    from relation_tpu_torch.core.trainer import build_model
    from relation_tpu_torch.entry import BUCKET, family_cfg
    from relation_tpu_torch.models.fpn import RelationRCNNFPN

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    trace.enable()
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
        calibrate_heads(model, predict, image, im_info)
    elif model.dcn:
        seed_offsets(model, cfg, image, im_info)
    for _ in range(2):
        predict(image, im_info)
    torch.cuda.synchronize()

    from torch.profiler import ProfilerActivity, profile
    trace.reset()
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
