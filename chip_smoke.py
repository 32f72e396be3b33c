#!/usr/bin/env python3
"""Smoke run of relation_tpu_torch on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py                  # every phase (the full check)
    python3 chip_smoke.py --phase kernels  # build + kernel-vs-plain only
    python3 chip_smoke.py --phase dcn      # build, kernel checks, DCN phases only
    python3 chip_smoke.py --phase trunk    # build, trunk kernel checks, phases 8-9
    python3 chip_smoke.py --phase fpn      # build, FPN kernel checks, phases 10-11
    python3 chip_smoke.py --phase workflow # build, rows 1, 2, 4, 5, 7, phase 12
    python3 chip_smoke.py --phase eval     # build, rows 1, 2, 4, 5, 7, 9, phase 13
    python3 chip_smoke.py --phase dp       # build, rows 1, 2, 4, 5, 7, 9, roi_pool, phase 14
    python3 chip_smoke.py --phase reference  # the same checks, phase 15
    python3 chip_smoke.py --phase cuts     # build, rows 1, 2, 4-7, 9, phase 16

1. Prints the card's name and power limit (nvidia-smi) and builds the CUDA
   kernels of relation_tpu_torch/csrc/ from source, one nvcc per source.
2. Holds each of the thirteen kernels against its plain PyTorch version on
   the card, at the shapes the driven models give it (the geometric bias at
   its seven launch shapes, its backward at five, among them the alternate
   workflow's head over 1016 rows against 300 keys, predict_rcnn's over
   1000 x 1000 and the train driver's over 400 rows (TPU.MAX_GT 100)
   against 300; the NMS at the end-to-end proposal shape, at the proposal
   dump's 20000 boxes with 2000 kept, and at the classic tail's C=80,
   Np=512, one kernel on the card a call (counted in one torch.profiler
   trace taken before the checks) that allocates its keep mask and nothing
   else; the stem, bit for bit as well, also at the portrait bucket; the
   fused attention at N=100 over every class and with class skipping at N=100 and at the FPN tail's N=150, two runs and the
   two entries bit-equal, timed beside the two-stage route (geometric
   bias, then bias attention) at the same inputs; the skip geometric bias
   and the bias attention with and without class skipping at the FPN
   learned-NMS tail's C=80, N=150, 16 or 80 classes active, and over 80
   classes at the C4 tail's N=100, two runs bit-equal, with the bound of
   the tensor-core route beside the f32 one; the deformable
   col2im at B=1 and B=2 of the 38x64 res5 map, bf16 and f32 rows, and of
   a 100x64 map, with the run-to-run difference its atomic ranks leave; the
   bottleneck stack at res4
   (22 blocks), res3 and res2 and the projection bottleneck at res2a, res3a
   and res4a of the 608x1024 trunk, on BN-folded weights of a seeded trunk),
   on seeded random inputs, and times kernel, plain version and (where
   PyTorch computes the same function) a library yardstick with CUDA
   events. The two trunk kernels have two: cuDNN convolutions,
   FrozenBatchNorm and ReLU through the port's Bottleneck modules, and a
   cuDNN chain on the folded bf16 weights (channels_last F.conv2d with
   bias, ReLU, residual add), the kernel's exact function; the JSON line
   holds the kernel to the faster of the two.
3. Drives the flagship (ResNet-101 C4/C5, 81 classes, 6000 -> 300
   proposals, relation head, learned NMS with FIRST_N 100, 608x1024 s2d
   input, init_params weights) through the port's entry points: two seeded
   requests with the default class threshold (the data picks the
   learned-NMS branch), then one with 56 active classes (dense branch) and
   one with 16 (skip kernel). Every inference kernel's launch counter,
   zeroed just before, must be above 0.
4. Runs the same requests with the plain versions in place of the kernels
   and holds the kernel path to them in the bands of tools/flagship_golden.py
   (each top-50 detection matched by a same-class detection at IoU >= 0.95,
   |score delta| <= 2e-2).
5. Trains the flagship at full width: a seeded batch of two s2d images with
   three ground-truth boxes each, three steps with the dense learned-NMS
   attention and two with the fully fused one. Every metric must be finite,
   the loss must move, every trainable leaf must move and no frozen one,
   the counters of the geometric-bias backward, the fused attention, the
   stem, the NMS and the geometric-bias forward must be above 0, and a
   first step's losses and update norm must agree with the same step run
   through the plain versions within 1e-3 relative.
6. Serves the DCN family at full width (deformable res5, deformable PSROI
   head; offset convs and offset FC seeded away from zero): two
   dcn_learn_nms requests and one dcn_relation request through the classic
   per-class NMS tail, kernel path against plain path in the same bands.
7. Trains dcn_learn_nms at full width, B=2: three steps under the clip (the
   col2im counter must show three launches a step), then one unclipped step
   on the kernels against the plain versions within 1e-3 relative, both in
   f32 compute (in bf16 the plain step is not reproducible to 1e-3 itself).
8. Serves the flagship with TPU.FUSE_RES4 through entry(), BN statistics
   jittered from a seed: two requests with res4b1..b22 as the stack kernel,
   held against the plain path in the bands of phase 4, the fused c4
   feature against the conv trunk's at correlation >= 0.999.
9. Runs ResNet101C4 on the 608x1024 image with trunk_folded (every res2..res4
   block a kernel), held against the plain versions and the conv trunk,
   and times the conv trunk, FUSE_RES4 and trunk_folded with CUDA events.
10. Serves the three FPN families through entry() at full width (prediction
   layers calibrated): fpn_learn_nms in its default split form at the
   default class threshold, with 16 active classes (the fused skip attention
   at N=150) and with 56 (geometric bias + dense attention), then in its
   single-module form with 16 (skip geometric bias + skip bias attention)
   and 48 (geometric bias + bias attention); one fpn_relation request
   (greedy per-class NMS tail) and one fpn request (soft-NMS tail). Each
   learned-NMS request must launch its branch's kernels; every request is
   held to the plain path in the bands of phase 4.
11. Trains fpn, fpn_relation and fpn_learn_nms at full width, B=2
   (prediction layers calibrated as in phase 10, the batch of phase 5): four
   steps under the clip (ms/step is the median of the last three), then one
   unclipped step on the kernels against the plain versions within 1e-3
   relative, as in phase 5; a trainable leaf that stays still must be an
   FPN bias at zero that the plain step gives no gradient either; the
   proposal NMS,
   the stem, the geometric bias and its backward (C=1 in the head's
   relation modules, C=80 N=150 in the learned-NMS branch) and the bias
   attention (fpn_learn_nms) launched as each family runs them. Prints
   ms/step and peak memory.
12. Runs fpn_learn_nms through the alternate (cached-proposal) workflow at
   full width (core/rpn_workflow.py; the YAML's TEST.PROPOSAL_* 20000 ->
   2000, TOP_ROIS 1000, FIXED_PARAMS_SHARED; calibrated, three seeded images
   of three boxes): two RPN-only steps; the proposal dump over the three
   images into a pickle (the NMS at 20000 boxes, 2000 kept), its top 300
   held to the plain path's; recall, the proposal roidb and the bbox-target
   statistics; three RCNN steps on the cached ROIs with train_shared (the
   FIXED_PARAMS_SHARED leaves bit-equal, every other trainable leaf moves,
   rows 1, 2 and 7 launched) and one unclipped step against the plain
   versions at 1e-3; the checkpoint written and restored into a freshly
   built model bit for bit; predict_rcnn from it held to the plain path and
   to the trained model in the bands of phase 4 (at score threshold 0: the
   three steps leave no class score above 1e-3), its merged scores within
   1e-3 of the plain path's largest. Prints ms/step of both steps, the
   dump's and predict_rcnn's ms/image and peak memory.
13. Runs the flagship end to end from a dataset on disk (run_eval): a
   seeded mini COCO-layout dataset (eight test images, six 480x640 and two
   640x480, in the (608, 1024) and (800, 1024) buckets; PNG files read
   through PIL, or, without PIL, the same arrays handed to the loaders),
   experiments/train.py for four steps through the TrainLoader (flipped
   entries, uint8 s2d batches), experiments/test.py on the newest params
   file it wrote, bit-equal to the trained model's own predictions on the
   TestLoader's items, pred_eval of the trained model bit-equal to them
   too, the kernel path in the bands of phase 4 of the plain path, the
   ground truth as detections at AP 1.0 and the NumPy matching route equal
   to the native one, then fpn_learn_nms's proposal dump over the test
   roidb (loader=None) and pred_eval_rcnn through the ProposalTestLoader.
   Prints ms/step, ms/image with its data/net/fetch/post split, the
   summarize time and the routes taken.
14. Data parallelism over torch.distributed (run_dp): two gloo ranks
   spawned on the one card (a file:// store; NCCL refuses two ranks on one
   GPU). The flagship YAML's train step in f32, one global batch of two
   images of three boxes, one a rank, against one process's step on the
   same two images from the same init_params(seed=0) weights and seed:
   every loss, the update's global L2 norm and every leaf's update within
   1e-3, both ranks' parameters bit-equal. Then pred_eval over the two
   ranks on a seeded mini COCO dataset of five images in two buckets (a
   partial group) against the sequential pred_eval, bit-equal (else held
   to phase 4's bands and reported). Prints ms/step and ms/image of both
   routes; the ranks' launches are read in their processes.
15. The reference-weights path (run_reference): the flagship written as an
   mx.nd.save v2 file under the reference's names and MXNet layouts,
   converted by relation_tpu_torch/tools/convert_reference_params.py (round
   trip bit-equal), evaluated by ``python -m
   relation_tpu_torch.experiments.test --roi-method auto`` in a process of
   its own (it must pick roi_method pool and the four parity keys), the
   same requests in this process with the kernels and with the plain
   versions in phase 4's bands, and two flagship train steps plus an
   unclipped pair with TPU.ROI_METHOD='pool' (the ROIPooling kernel forward
   and backward, kernel step against plain step within 1e-3). The
   ROIPooling kernel's own check (in phase 2) runs at the C4 head's shape
   in f32 and bf16, at the portrait bucket's 50x64 map in bf16 and at the
   four FPN levels of a 608x1024 image; inference launches the forward
   without the argmax, the train step the forward with it.
16. The production-shape gate and the train steps' cuts (run_gate,
   run_cuts): the flagship through entry() at 608x1024 in f32 on
   init_params(seed=0) weights with the four calibration factors of
   tests/golden/flagship_port.npz applied on the host, one request on the
   kernels held to the JAX package's detections in that file in the bands
   of phase 4 (relation_tpu_torch/tools/flagship_golden.py), and one in the
   flagship's own bf16-trunk configuration (the stem kernel on the path),
   its head feature held to the JAX package's bf16 one in that file within
   3e-2 (mean |delta| / mean |x|); then every
   stop_after cut once at full width, B=2, without weight decay: the
   flagship end-to-end step's eleven cuts, the full step and lnms_attn
   under fully_fused, and the fpn_learn_nms RCNN step's 'trunk', 'sample',
   'pool', 'head' and full step on 1000 cached ROIs. Each cut: finite
   metrics, a pure tap's loss at most 1e-20, gradients delivered to exactly
   the parameter groups the cut reaches (a leaf it does not reach stays
   bit-equal), the launch counters showing where the learned-NMS
   attention runs (none before lnms_attn; rows 1, 2 and 7, or row 6 under
   fully_fused, from it on); each cut's ms on the host clock and by CUDA
   events.
17. Prints the launches of rows 1, 2, 4, 7, 9 and roi_pool by shape, one
   JSON line describing every kernel (launches summed over the driven
   paths), then the device line.

Any failure exits non-zero without the last line. Needs no network; the
kernels build into relation_tpu_torch/_build/.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
MEM_BW = 3.35e12          # H100 SXM HBM3, bytes/s (data sheet)
F32_PEAK = 67e12          # f32 outside the tensor cores, flop/s
BF16_PEAK = 989e12        # dense bf16 tensor cores, flop/s
TF32_PEAK = 495e12        # dense TF32 tensor cores, flop/s
SINCOS_FLOPS = 24         # one sin/cos pair: range reduction + two polynomials
IOU_FLOPS = 15            # one divide-free suppression test
TOP_K, IOU_MIN, SCORE_ATOL = 50, 0.95, 2e-2   # tools/flagship_golden.py bands


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound(bytes_moved: float, flops: float, peak: float):
    """(bound_ms, bound_by): the larger of memory time and compute time."""
    t_mem, t_ops = bytes_moved / MEM_BW, flops / peak
    return (max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops else "operations")


def f32_bound(bytes_moved: float, products: float, rest: float):
    """(bound_ms, bound_by, simt_ms) of f32 work: the matrix products at the
    dense TF32 tensor-core rate (split TF32 carries them at f32 accuracy),
    the rest (sin/cos, softmax, elementwise) at the f32 rate; simt_ms is the
    bound with every flop at the f32 rate, printed beside it."""
    t_mem = bytes_moved / MEM_BW
    t_ops = products / TF32_PEAK + rest / F32_PEAK
    simt_ms = max(t_mem, (products + rest) / F32_PEAK) * 1e3
    return (max(t_mem, t_ops) * 1e3,
            "bytes" if t_mem >= t_ops else "operations", simt_ms)


def time_ms(torch, fn, inner: int = 10, reps: int = 21) -> float:
    """Median device ms per call. A long sleep kernel first lets the host
    queue all `inner` calls, so the events bracket device time only."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def random_boxes(rng, n, im_w=1000.0, im_h=600.0, clusters=60):
    """Clustered boxes like RPN proposals: [n, 4] (x1, y1, x2, y2) f32."""
    centers = rng.uniform([0, 0], [im_w, im_h], (clusters, 2))
    cxy = centers[rng.randint(0, clusters, n)] + rng.randn(n, 2) * 12
    wh = np.exp(rng.uniform(np.log(16), np.log(400), (n, 2)))
    b = np.concatenate([cxy - wh / 2, cxy + wh / 2], 1)
    b[:, 0::2] = b[:, 0::2].clip(0, im_w - 1)
    b[:, 1::2] = b[:, 1::2].clip(0, im_h - 1)
    return b.astype(np.float32)


# --------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# --------------------------------------------------------------------------

def check_geom_bias(torch, dev, rng):
    from relation_tpu_torch.ops.embeddings import (
        extract_multi_position_matrix_t, extract_position_matrix_t)
    from relation_tpu_torch.ops.kernels import geom_bias as K
    G = 16
    w = torch.tensor(rng.randn(64, G) * 0.1, dtype=torch.float32, device=dev)
    b = torch.tensor(rng.randn(G) * 0.05, dtype=torch.float32, device=dev)
    shapes = {
        # head relation modules: [1, 4, 300, 300], called twice per image
        "head C=1 N=M=300": extract_position_matrix_t(
            torch.tensor(random_boxes(rng, 300), device=dev), 300)[None],
        # learned-NMS dense branch: [80, 4, 100, 100]
        "lnms C=80 N=M=100": extract_multi_position_matrix_t(
            torch.tensor(np.stack([random_boxes(rng, 100) for _ in range(80)], 1),
                         device=dev)),
    }
    # the other two launch shapes of the driven paths: the head in training
    # (300 proposals + 16 ground-truth rows against 300 keys) and the FPN
    # learned-NMS tail (FIRST_N 150); their own stream, so that the two
    # shapes above and every later draw of rng stay as they were
    rng2 = np.random.RandomState(10)
    shapes.update({
        "head C=1 N=316 M=300": extract_position_matrix_t(
            torch.tensor(random_boxes(rng2, 316), device=dev), 300)[None],
        "fpn C=80 N=M=150": extract_multi_position_matrix_t(
            torch.tensor(np.stack([random_boxes(rng2, 150) for _ in range(80)], 1),
                         device=dev)),
    })
    # the alternate workflow's (phase 12): the RCNN step's head over 1000
    # cached ROIs + 16 ground-truth rows against 300 keys, and predict_rcnn's
    # over 1000 ROIs, every one a key
    rng3 = np.random.RandomState(13)
    shapes.update({
        "rcnn C=1 N=1016 M=300": extract_position_matrix_t(
            torch.tensor(random_boxes(rng3, 1016), device=dev), 300)[None],
        "predict_rcnn C=1 N=M=1000": extract_position_matrix_t(
            torch.tensor(random_boxes(rng3, 1000), device=dev), 1000)[None],
    })
    # the train driver's (phase 13): the flagship YAML's TPU.MAX_GT 100
    # ground-truth rows padded onto 300 proposals, against 300 keys
    shapes["driver C=1 N=400 M=300"] = extract_position_matrix_t(
        torch.tensor(random_boxes(np.random.RandomState(15), 400), device=dev),
        300)[None]
    json_shape = "lnms C=80 N=M=100"
    result = None
    for label, pos in shapes.items():
        pos = pos.contiguous()
        C, _, N, M = pos.shape
        got = K._launch(pos, w, b, 100.0)
        want = K.geom_bias_reference(pos, w, b)
        torch.cuda.synchronize()
        # acc domain (log() near the 1e-6 clamp amplifies any rounding), and
        # the log itself where acc is clear of the clamp
        err = float((got.exp() - want.exp()).abs().max())
        clear = want.exp() > 1e-2
        err_log = float((got - want)[clear].abs().max())
        tol = 1e-5
        ok = err <= tol and err_log <= 1e-4 and bool(torch.isfinite(got).all())
        ms = time_ms(torch, lambda: K._launch(pos, w, b, 100.0))
        plain_ms = time_ms(torch, lambda: K.geom_bias_reference(pos, w, b))
        pairs = C * N * M
        bms, bby, simt = f32_bound(4 * (4 * pairs + G * pairs + 65 * G),
                                   pairs * 2 * 64 * G,
                                   pairs * (32 * SINCOS_FLOPS + 3 * G))
        log(f"[kernel] geom_bias {label}: max|exp err| {err:.3e} (tol {tol:.0e}), "
            f"max|log err| where acc>1e-2 {err_log:.3e} (tol 1e-4) "
            f"{'OK' if ok else 'FAIL'}; kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
            f"library_ms n/a bound_us {bms * 1e3:.2f} ({bby}; all flops at the "
            f"f32 rate: {simt * 1e3:.2f})")
        if not ok:
            fail(f"geom_bias {label} disagrees with its plain version")
        if label == json_shape:
            result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bms, bound_by=bby, library_ms=None)
    return result  # the learned-NMS shape of earlier slices' JSON lines


def check_geom_bias_bwd(torch, dev, rng):
    from relation_tpu_torch.ops.embeddings import (
        extract_multi_position_matrix_t, extract_position_matrix_t)
    from relation_tpu_torch.ops.kernels import geom_bias as K
    G = 16
    w = torch.tensor(rng.randn(64, G) * 0.1, dtype=torch.float32, device=dev)
    b = torch.tensor(rng.randn(G) * 0.05, dtype=torch.float32, device=dev)
    shapes = {
        # head relation modules in training: 300 proposals + 16 ground-truth
        # rows against 300 keys, twice per image
        "head C=1 N=316 M=300": extract_position_matrix_t(
            torch.tensor(random_boxes(rng, 316), device=dev), 300)[None],
        # learned-NMS dense branch: [80, 4, 100, 100], once per image
        "lnms C=80 N=M=100": extract_multi_position_matrix_t(
            torch.tensor(np.stack([random_boxes(rng, 100) for _ in range(80)], 1),
                         device=dev)),
        # the FPN learned-NMS dense branch (FIRST_N 150), once per image
        "lnms C=80 N=M=150": extract_multi_position_matrix_t(
            torch.tensor(np.stack([random_boxes(rng, 150) for _ in range(80)], 1),
                         device=dev)),
        # the alternate workflow's RCNN step (phase 12): 1000 cached ROIs +
        # 16 ground-truth rows against 300 keys, twice per image
        "rcnn C=1 N=1016 M=300": extract_position_matrix_t(
            torch.tensor(random_boxes(np.random.RandomState(14), 1016),
                         device=dev), 300)[None],
        # the train driver's (phase 13): 300 proposals + TPU.MAX_GT 100
        # ground-truth rows against 300 keys
        "driver C=1 N=400 M=300": extract_position_matrix_t(
            torch.tensor(random_boxes(np.random.RandomState(16), 400),
                         device=dev), 300)[None],
    }
    result = None
    for label, pos in shapes.items():
        pos = pos.contiguous()
        C, _, N, M = pos.shape
        pairs = C * N * M
        # the cotangent is zero close to the clamp (-1e-3 < acc < 2e-2):
        # there 1/acc amplifies the last-bit difference between two f32 sums
        # of acc (about 1e-7) beyond the 1e-4 band, up to 1e6 times at the
        # clamp itself; clamped pairs and all others are held
        acc_ref = K.geom_acc_reference(pos, w, b)
        clear = (acc_ref > 2e-2) | (acc_ref < -1e-3)
        gout = torch.tensor(rng.randn(C, G, N, M), dtype=torch.float32,
                            device=dev) * clear
        got = K._launch_bwd(pos, w, b, gout, 100.0)
        again = K._launch_bwd(pos, w, b, gout, 100.0)
        want = K.geom_bias_bwd_reference(pos, w, b, gout)
        torch.cuda.synchronize()
        errs, ok = [], True
        for name, x, y, z in zip(("d_pos", "d_W", "d_b"), got, want, again):
            err, top = float((x - y).abs().max()), float(y.abs().max())
            errs.append(f"{name} {err:.3e}/{top:.3e}")
            ok = ok and err <= 1e-4 * top and bool(torch.isfinite(x).all())
            ok = ok and torch.equal(x, z)
        # clamp decisions: b moved so that pair 0 of class 0 sits on the
        # clamp in every head; the backward's acc must be the forward's,
        # bit for bit, on every element
        b_clamp = (b + 1e-6 - acc_ref[0, :, 0, 0]).contiguous()
        ones = torch.ones_like(gout)
        acc_fwd = K._launch(pos, w, b_clamp, 100.0, raw=True)
        acc_bwd = K._launch_bwd(pos, w, b_clamp, ones, 100.0, need_pos=False,
                                want_acc=True)[3]
        torch.cuda.synchronize()
        near = int(((acc_fwd - 1e-6).abs() < 1e-6).sum())
        clamp_ok = torch.equal(acc_fwd, acc_bwd) and near >= G
        ms = time_ms(torch, lambda: K._launch_bwd(pos, w, b, gout, 100.0))
        ms_model = time_ms(torch, lambda: K._launch_bwd(pos, w, b, gout, 100.0,
                                                        need_pos=False))
        plain_ms = time_ms(torch, lambda: K.geom_bias_bwd_reference(
            pos, w, b, gout), inner=2, reps=7)
        # per pair: three 64 x G products (acc, d_trig, d_W) on the tensor
        # cores; 32 sin/cos, the clamp/divide and the d_pos tail at f32
        products, rest = pairs * 3 * 2 * 64 * G, pairs * (
            32 * SINCOS_FLOPS + 4 * G + 32 * 5)
        bms, bby, simt = f32_bound(4 * ((4 + G + 4) * pairs + 2 * 65 * G),
                                   products, rest)
        mbms, mbby, _ = f32_bound(4 * ((4 + G) * pairs + 2 * 65 * G), products,
                                  rest)
        log(f"[kernel] geom_bias_bwd {label}: max abs err / max "
            f"{', '.join(errs)} (tol 1e-4 of max), two runs bit-equal, "
            f"{'OK' if ok else 'FAIL'}; clamp: acc of forward and backward "
            f"bit-equal on {pairs * G} elements, {near} within 1e-6 of the "
            f"clamp, {'OK' if clamp_ok else 'FAIL'}; kernel_ms {ms:.4f} "
            f"(without d_pos, as the model runs it: {ms_model:.4f}, bound_us "
            f"{mbms * 1e3:.2f} ({mbby})) plain_ms {plain_ms:.4f} library_ms n/a "
            f"bound_us {bms * 1e3:.2f} ({bby}; all flops at the f32 rate: "
            f"{simt * 1e3:.2f})")
        if not (ok and clamp_ok):
            fail(f"geom_bias_bwd {label} disagrees with its plain version")
        if label == "lnms C=80 N=M=100":
            result = dict(max_abs_err=float((got[1] - want[1]).abs().max()),
                          ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                          library_ms=None)
    return result  # the C4 learned-NMS shape goes into the JSON line


def nms_tests(keep, valid, block, max_keep, T=256):
    """(IoU tests the one-launch kernel makes on this data, modelled from its
    code on the plain keep mask; the chunk at which it stops): per chunk it
    visits (T boxes, stopping at the first ``block`` boundary with
    ``max_keep`` kept; a chunk with no valid box is passed over), each valid
    box against every box kept before the chunk, and every item of the
    chunk's upper triangle (T/32 x (T/32 + 1) / 2 items of 32 x 32 tests,
    invalid rows and columns included)."""
    n_kept, tests, Np = 0, 0, keep.shape[0]
    h = T // 32
    for lo in range(0, Np, T):
        if lo % block == 0 and n_kept >= max_keep:
            return tests, lo
        v = valid[lo:lo + T] > 0
        if v.any():
            tests += int(v.sum()) * n_kept + h * (h + 1) // 2 * 32 * 32
        n_kept += int(keep[lo:lo + T].sum())
    return tests, Np


def nms_kernels_a_call(torch, dev) -> dict:
    """{"C= Np=": names of the CUDA kernels and copies one nms_keep_sorted
    call puts on the card} at the proposals' shape and the classic tail's,
    from one torch.profiler trace taken before any kernel check (seeded
    boxes of their own; the count does not depend on the data). A fill of a
    one-element tensor stands before, between and after the calls in the
    trace. Later in the process, after the other kernel checks, the profiler
    on the H100 has recorded no device activity in a session at all, five
    sessions in a row."""
    from torch.profiler import ProfilerActivity, profile

    from relation_tpu_torch.ops.kernels import nms_kernel as K
    rng = np.random.RandomState(10)
    calls = {}
    for C, n, np_pad, max_keep, thresh in ((1, 6000, 6144, 300, 0.7),
                                           (80, 300, 512, 100, 0.3),
                                           (1, 20000, 20224, 2000, 0.7)):
        bT = np.zeros((C, 4, np_pad), np.float32)
        valid = np.zeros((C, np_pad), np.float32)
        for c in range(C):
            bT[c, :, :n] = random_boxes(rng, n).T
        valid[:, :n] = 1.0
        args = (torch.tensor(bT, device=dev), torch.tensor(valid, device=dev),
                thresh, 256, max_keep)
        K.nms_keep_sorted(*args)      # built and set up before the trace
        calls[f"C={C} Np={np_pad}"] = args
    mark = torch.empty(1, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for args in calls.values():
            mark.fill_(1.0)
            K.nms_keep_sorted(*args)
        mark.fill_(1.0)
        torch.cuda.synchronize()
    events = sorted((e.time_range.start, e.name) for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    groups, cur = [], None
    for _, name in events:
        if "FillFunctor" in name:
            if cur is not None:
                groups.append(cur)
            cur = []
        elif cur is not None:
            cur.append(name)
    if len(groups) != len(calls):
        fail(f"torch.profiler's trace of the NMS calls is incomplete: "
             f"{len(events)} device events")
    return dict(zip(calls, groups))


def check_nms(torch, dev, rng, ran):
    """nms_keep_sorted at the end-to-end proposals' shape (6000 boxes, 300
    kept; in the JSON line), then at the proposal dump's of the alternate
    workflow (TEST.PROPOSAL_*: 20000 boxes, 2000 kept), on boxes of its own
    stream. ``ran``: {"C= Np=": the kernels a call put on the card}."""
    result = _check_nms(torch, dev, rng, ran["C=1 Np=6144"], 6000, 300, 25)
    _check_nms(torch, dev, np.random.RandomState(12), ran["C=1 Np=20224"],
               20000, 2000, 200)
    return result


def _check_nms(torch, dev, rng, ran, n, max_keep, clusters):
    from relation_tpu_torch.ops.kernels import nms_kernel as K
    block, thresh = 256, 0.7
    np_pad = -(-n // block) * block
    boxes = random_boxes(rng, n, clusters=clusters)
    # the boxes stand in a random score order, already sorted: the NMS
    # input contract
    bT = np.zeros((1, 4, np_pad), np.float32)
    bT[0, :, :n] = boxes.T
    valid = np.zeros((1, np_pad), np.float32)
    valid[0, :n] = 1.0
    bT_t = torch.tensor(bT, device=dev)
    v_t = torch.tensor(valid, device=dev)

    def kernel():
        return K.nms_keep_sorted(bT_t, v_t, thresh, block, max_keep)
    kernel()
    torch.cuda.synchronize()
    # one kernel on the card a call (``ran``: the profiler's trace), and no
    # device memory but the keep mask
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    got = kernel()
    torch.cuda.synchronize()
    alloc = torch.cuda.max_memory_allocated(dev) - base
    calls = len(ran)
    want = K.nms_keep_sorted_reference(bT_t, v_t, thresh, block, max_keep)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    keep = want[0].cpu().numpy() > 0.5
    kept_idx = np.nonzero(keep)[0]
    mask_bytes = -(-np_pad * 4 // 512) * 512      # the allocator's 512-byte unit
    ok = (err == 0.0 and len(kept_idx) >= max_keep and calls == 1
          and "nms_kernel" in ran[0] and alloc <= mask_bytes)
    ms = time_ms(torch, kernel)
    plain_ms = time_ms(torch, lambda: K.nms_keep_sorted_reference(
        bT_t, v_t, thresh, block, max_keep), inner=1)
    # work this data needs: the walk stops at the block boundary after the
    # max_keep-th kept box; each kept box is tested against the later boxes
    tests, stop = nms_tests(keep, valid[0], block, max_keep)
    pairs = float(sum(stop - i - 1 for i in kept_idx if i < stop))
    bms, bby = bound(np_pad * (16 + 4 + 4), IOU_FLOPS * pairs, F32_PEAK)
    log(f"[kernel] nms_keep_sorted C=1 Np={np_pad} t={thresh} max_keep={max_keep}: "
        f"keep-mask mismatches {err:.0f} (tol 0) {'OK' if ok else 'FAIL'}; "
        f"kept {int(keep.sum())} by box {stop}; {calls} kernel a call on the "
        f"card ({', '.join(ran)}), {alloc} device bytes allocated (the keep "
        f"mask: {np_pad * 4}); IoU tests {tests}, modelled (the two-pass "
        f"bitmask design's mask pass: "
        f"{np_pad * (np_pad - 1) // 2}); kernel_ms {ms:.4f} plain_ms "
        f"{plain_ms:.4f} library_ms n/a; IoU-pass bound_us {bms * 1e3:.3f} "
        f"({bby}, {pairs:.0f} pairs)")
    if not ok:
        fail("nms_keep_sorted disagrees with its plain version, or put more "
             "than one kernel on the card or took more device memory than its "
             "keep mask")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=bby, library_ms=None)


def check_stem(torch, dev, rng):
    import torch.nn.functional as F
    from relation_tpu_torch.models.backbone import conv1_w4
    from relation_tpu_torch.ops.kernels import stem as K
    Ho, Wo = 304, 512
    s2d = torch.tensor(rng.randn(1, 12, Ho, Wo) * 40, dtype=torch.float32, device=dev)
    w7 = torch.tensor(rng.randn(64, 3, 7, 7) * (1 / 147) ** 0.5,
                      dtype=torch.float32, device=dev)
    w4 = conv1_w4(w7).contiguous()
    scale = torch.tensor(rng.uniform(0.5, 2, 64), dtype=torch.float32, device=dev)
    bias = torch.tensor(rng.randn(64), dtype=torch.float32, device=dev)
    wf = K.stem_weight_fragments(w4)
    got = K._launch(s2d, wf, scale, bias).float()
    want = K.stem_reference(s2d, w4, scale, bias).float()
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err = float(diff.max())
    # one bf16 ulp of the plain value (its pre-activation is the exact sum of
    # the bf16 products rounded once to f32; the kernel's is the tensor
    # cores' f32 sum, and the exact one where BN brings the output near zero)
    ok = bool((diff <= want.abs() * 2.0 ** -7 + 1e-6).all())
    same = torch.equal(got, want)
    ms = time_ms(torch, lambda: K._launch(s2d, wf, scale, bias))
    plain_ms = time_ms(torch, lambda: K.stem_reference(s2d, w4, scale, bias))
    # yardstick: cuDNN 7x7/2 conv (BN folded into weight and bias) + ReLU on
    # the NCHW image the s2d input encodes
    img = s2d[0].reshape(2, 2, 3, Ho, Wo).permute(2, 3, 0, 4, 1).reshape(
        1, 3, 2 * Ho, 2 * Wo).to(torch.bfloat16)
    wfold = (w7 * scale[:, None, None, None]).to(torch.bfloat16)
    bf = bias.to(torch.bfloat16)
    lib = F.relu(F.conv2d(img, wfold, bf, stride=2, padding=3)).float()
    lib_err = float((lib - want).abs().max())
    library_ms = time_ms(torch, lambda: F.relu_(F.conv2d(img, wfold, bf, stride=2,
                                                         padding=3)))
    bms, bby = bound(12 * Ho * Wo * 4 + 64 * Ho * Wo * 2 + 192 * 64 * 2 + 512,
                     2 * 64 * 192 * Ho * Wo, BF16_PEAK)
    log(f"[kernel] stem_conv1_bn_relu [12,{Ho},{Wo}]: max abs err {err:.3e} "
        f"(tol 1 bf16 ulp), bit-equal: {same}, {'OK' if ok else 'FAIL'}; "
        f"library max abs diff "
        f"{lib_err:.3e}; kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
        f"library_ms {library_ms:.4f} bound_us {bms * 1e3:.2f} ({bby})")
    if not ok:
        fail("stem_conv1_bn_relu disagrees with its plain version")
    # the portrait bucket (800x1024) of the data path (phase 13), on the same
    # weights, its image from a stream of its own
    tall = torch.tensor(np.random.RandomState(17).randn(1, 12, 400, Wo) * 40,
                        dtype=torch.float32, device=dev)
    got = K._launch(tall, wf, scale, bias).float()
    want = K.stem_reference(tall, w4, scale, bias).float()
    torch.cuda.synchronize()
    tall_same = torch.equal(got, want)
    tall_ms = time_ms(torch, lambda: K._launch(tall, wf, scale, bias))
    tall_plain_ms = time_ms(torch, lambda: K.stem_reference(tall, w4, scale,
                                                            bias))
    tall_img = tall[0].reshape(2, 2, 3, 400, Wo).permute(2, 3, 0, 4, 1).reshape(
        1, 3, 800, 2 * Wo).to(torch.bfloat16)
    tall_library_ms = time_ms(torch, lambda: F.relu_(F.conv2d(
        tall_img, wfold, bf, stride=2, padding=3)))
    tall_bms, tall_bby = bound(12 * 400 * Wo * 4 + 64 * 400 * Wo * 2
                               + 192 * 64 * 2 + 512, 2 * 64 * 192 * 400 * Wo,
                               BF16_PEAK)
    log(f"[kernel] stem_conv1_bn_relu [12,400,{Wo}]: max abs err "
        f"{float((got - want).abs().max()):.3e}, bit-equal: {tall_same}; "
        f"kernel_ms {tall_ms:.4f} plain_ms {tall_plain_ms:.4f} library_ms "
        f"{tall_library_ms:.4f} bound_us {tall_bms * 1e3:.2f} ({tall_bby})")
    if not tall_same:
        fail("stem_conv1_bn_relu at the portrait bucket differs from its plain "
             "version")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=bby, library_ms=library_ms)


def attention_inputs(torch, dev, rng, C=80, N=100, G=16, D=64, Fd=128, E=8):
    from relation_tpu_torch.ops.embeddings import extract_multi_position_matrix_t

    def tens(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)
    pos = extract_multi_position_matrix_t(tens(np.stack(
        [random_boxes(rng, N) for _ in range(C)], 1))).contiguous()
    q, k = tens(rng.randn(C, N, G * D) * 0.5), tens(rng.randn(C, N, G * D) * 0.5)
    v = tens(rng.randn(C, N, Fd))
    wg, bg = tens(rng.randn(64, G) * 0.1), tens(rng.randn(G) * 0.05)
    wl = tens(rng.randn(G, Fd, E) * 0.1)
    return pos, q, k, v, wg, bg, wl


def attention_bound(A, C, N, G, D, Fd, E):
    """Bound of the fused attention over A computed classes of C, with the
    product re-associated as attn @ (v @ Wl_g): the least work the function
    needs; the products at the TF32 rate (f32_bound)."""
    products = A * (2 * N * N * D * G + 2 * 64 * G * N * N + 2 * N * Fd * E * G
                    + 2 * N * N * E * G)
    rest = A * N * N * (32 * SINCOS_FLOPS + 5 * G)
    nbytes = A * 4 * (4 * N * N + 2 * N * G * D + N * Fd + N * G * E) + 4 * (
        64 * G + G + G * Fd * E + C)
    return f32_bound(nbytes, products, rest)


def sdpa_ms(torch, pos, q, k, v, wg, bg, N, G, D, Fd):
    """Yardstick for the attention core: SDPA with the bias as a float mask."""
    from relation_tpu_torch.ops.kernels import geom_bias as GB
    return sdpa_bias_ms(torch, GB.geom_bias_reference(pos, wg, bg), q, k, v, G, D)


def sdpa_bias_ms(torch, bias, q, k, v, G, D):
    """SDPA over the heads of every class of q, with the [A, G, N, N] bias
    as a float attention mask (the attention core, no linear_out)."""
    import torch.nn.functional as F
    A, N, Fd = q.shape[0], q.shape[1], v.shape[2]
    qs = q.reshape(A, N, G, D).transpose(1, 2)
    ks = k.reshape(A, N, G, D).transpose(1, 2)
    vs = v[:, None].expand(A, G, N, Fd)
    return time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=bias))


def check_attention(torch, dev, rng):
    """Row 9 at the flagship's N=100 (FIRST_N 100; the JSON line) and at the
    FPN learned-NMS tail's N=150 (FIRST_N 150), 16 of 80 classes active;
    timed beside the two-stage route at the same inputs (row 3, then row
    8)."""
    from relation_tpu_torch.ops.kernels import bias_attention as BA
    from relation_tpu_torch.ops.kernels import geom_bias as GB
    from relation_tpu_torch.ops.kernels import nms_attention as K
    C, G, D, Fd, E, n_active = 80, 16, 64, 128, 8, 16
    result = None
    for N in (100, 150):
        pos, q, k, v, wg, bg, wl = attention_inputs(torch, dev, rng, N=N)
        act_np = np.zeros(C, np.int32)
        act_np[rng.choice(C, n_active, replace=False)] = 1
        active = torch.tensor(act_np, device=dev)
        args = (pos, q, k, v, wg, bg, wl, active)
        got = K.fused_nms_relation_attention_skip(*args)
        want = K.nms_relation_attention_reference(*args)
        again = K.fused_nms_relation_attention_skip(*args)
        full = K.fused_nms_relation_attention(*args[:7])
        torch.cuda.synchronize()
        on = active.bool()
        err = float((got[on] - want[on]).abs().max())
        tol = 1e-4 * max(1.0, float(want[on].abs().max()))
        same = torch.equal(got[on], again[on]) and torch.equal(got[on], full[on])
        ok = err <= tol and same and bool(torch.isfinite(got[on]).all())
        ms = time_ms(torch, lambda: K.fused_nms_relation_attention_skip(*args))
        plain_ms = time_ms(torch, lambda: K.nms_relation_attention_reference(*args))
        idx = torch.nonzero(on).flatten()
        library_ms = sdpa_ms(torch, pos[idx], q[idx], k[idx], v[idx], wg, bg,
                             N, G, D, Fd)
        two_ms = time_ms(torch, lambda: BA.fused_bias_attention_skip(
            GB.fused_geometric_bias_skip(pos, wg, bg, active), q, k, v, wl,
            active))
        bms, bby, simt = attention_bound(n_active, C, N, G, D, Fd, E)
        log(f"[kernel] nms_attention_skip C={C} N={N} active={n_active}: max abs "
            f"err on active rows {err:.3e} (tol {tol:.1e}), two runs and the "
            f"full entry bit-equal on active rows: {same}, "
            f"{'OK' if ok else 'FAIL'}; kernel_ms {ms:.4f} plain_ms "
            f"{plain_ms:.4f} library_ms(SDPA core) {library_ms:.4f} "
            f"two-stage_ms(row 3 + row 8) {two_ms:.4f} bound_us "
            f"{bms * 1e3:.2f} ({bby}; all flops at the f32 rate: "
            f"{simt * 1e3:.2f})")
        if not ok:
            fail(f"fused_nms_relation_attention_skip N={N} disagrees with its "
                 "plain version")
        if result is None:
            result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                          bound_by=bby, library_ms=library_ms)
    return result   # N=100, the shape of the earlier slices' JSON lines


def fpn_tail_inputs(torch, dev, rng, n_active):
    """The two-stage attention's inputs at the FPN learned-NMS tail: C=80,
    N=150 (FIRST_N 150), G=16, D=64, F=128, E=8, with n_active classes
    active."""
    C = 80
    pos, q, k, v, wg, bg, wl = attention_inputs(torch, dev, rng, C=C, N=150)
    act_np = np.zeros(C, np.int32)
    act_np[rng.choice(C, n_active, replace=False)] = 1
    return pos, q, k, v, wg, bg, wl, torch.tensor(act_np, device=dev)


def check_geom_bias_skip(torch, dev, rng):
    """Row 3: the class-skipping geometric bias, 16 of 80 classes active."""
    from relation_tpu_torch.ops.kernels import geom_bias as K
    from relation_tpu_torch.ops.embeddings import extract_multi_position_matrix_t
    C, N, G, n_active = 80, 150, 16, 16
    w = torch.tensor(rng.randn(64, G) * 0.1, dtype=torch.float32, device=dev)
    b = torch.tensor(rng.randn(G) * 0.05, dtype=torch.float32, device=dev)
    pos = extract_multi_position_matrix_t(torch.tensor(
        np.stack([random_boxes(rng, N) for _ in range(C)], 1),
        device=dev)).contiguous()
    act_np = np.zeros(C, np.int32)
    act_np[rng.choice(C, n_active, replace=False)] = 1
    active = torch.tensor(act_np, device=dev)
    M = N
    got = K.fused_geometric_bias_skip(pos, w, b, active)
    want = K.geom_bias_skip_reference(pos, w, b, active)
    full = K._launch(pos, w, b, 100.0)
    torch.cuda.synchronize()
    on = active.bool()
    err = float((got[on].exp() - want[on].exp()).abs().max())
    clear = want[on].exp() > 1e-2
    err_log = float((got[on] - want[on])[clear].abs().max())
    same = torch.equal(got[on], full[on])
    ok = (err <= 1e-5 and err_log <= 1e-4 and same
          and bool(torch.isfinite(got[on]).all()))
    ms = time_ms(torch, lambda: K.fused_geometric_bias_skip(pos, w, b, active))
    plain_ms = time_ms(torch, lambda: K.geom_bias_skip_reference(pos, w, b, active))
    pairs = n_active * N * M          # the work of the active classes only
    bms, bby, simt = f32_bound(4 * (4 * pairs + G * pairs + 65 * G + C),
                               pairs * 2 * 64 * G,
                               pairs * (32 * SINCOS_FLOPS + 3 * G))
    log(f"[kernel] geom_bias_skip C={C} N=M={N} active={n_active}: max|exp err| "
        f"{err:.3e} (tol 1e-5), max|log err| where acc>1e-2 {err_log:.3e} (tol "
        f"1e-4), active rows bit-equal to the unskipped kernel: {same}, "
        f"{'OK' if ok else 'FAIL'}; kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
        f"library_ms n/a bound_us {bms * 1e3:.2f} ({bby}; all flops at the f32 "
        f"rate: {simt * 1e3:.2f})")
    if not ok:
        fail("fused_geometric_bias_skip disagrees with its plain version")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=bby, library_ms=None)


def bias_attention_bound(A, C, N, G, D, Fd, E):
    """Bound of the bias attention over A computed classes of C: QK^T, the
    softmax, v @ Wl_g and attn @ (v @ Wl_g) (the re-associated product, the
    least work the function needs), the three products at the TF32 rate
    (f32_bound); the bias, q, k, v of those classes read and their output
    written once."""
    products = A * (2 * N * N * D * G + 2 * N * Fd * E * G + 2 * N * N * E * G)
    nbytes = A * 4 * (G * N * N + 2 * N * G * D + N * Fd + N * G * E) + 4 * (
        G * Fd * E + C)
    return f32_bound(nbytes, products, A * 5 * N * N * G)


def _check_bias_attention(torch, dev, rng, skip: bool):
    from relation_tpu_torch.ops.kernels import bias_attention as K
    from relation_tpu_torch.ops.kernels.geom_bias import geom_bias_reference
    G, D, E = 16, 64, 8
    n_active = 16 if skip else 80
    pos, q, k, v, wg, bg, wl, active = fpn_tail_inputs(torch, dev, rng, n_active)
    C, N, Fd = q.shape[0], q.shape[1], v.shape[2]
    bias = geom_bias_reference(pos, wg, bg).contiguous()
    del pos
    if skip:
        def kernel():
            return K.fused_bias_attention_skip(bias, q, k, v, wl, active)
    else:
        def kernel():
            return K.fused_bias_attention(bias, q, k, v, wl)

    def plain():
        return K.bias_attention_reference(bias, q, k, v, wl,
                                          active if skip else None)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    on = active.bool()
    err = float((got[on] - want[on]).abs().max())
    tol = 1e-4 * max(1.0, float(want[on].abs().max()))
    ok = err <= tol and bool(torch.isfinite(got[on]).all())
    ms = time_ms(torch, kernel)
    plain_ms = time_ms(torch, plain, inner=2, reps=11)
    idx = torch.nonzero(on).flatten()
    library_ms = sdpa_bias_ms(torch, bias[idx], q[idx], k[idx], v[idx], G, D)
    bms, bby, simt = bias_attention_bound(n_active, C, N, G, D, Fd, E)
    again = kernel()
    torch.cuda.synchronize()
    same = torch.equal(got[on], again[on])
    ok = ok and same
    name = "bias_attention_skip" if skip else "bias_attention"
    log(f"[kernel] {name} C={C} N={N} active={n_active}: max abs err on active "
        f"rows {err:.3e} (tol {tol:.1e}), two runs bit-equal: {same}, "
        f"{'OK' if ok else 'FAIL'}; kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
        f"library_ms(SDPA core) {library_ms:.4f} bound_us {bms * 1e3:.2f} ({bby}; "
        f"all flops at the f32 rate: {simt * 1e3:.2f})")
    if not ok:
        fail(f"fused_{name} disagrees with its plain version")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=bby, library_ms=library_ms)


def check_bias_attention(torch, dev, rng):
    """Row 7 over all 80 classes (the dense two-stage tail) at the FPN tail's
    N=150 (the JSON line), then at the C4 tail's N=100, where most of its
    launches run: held to the plain version and timed, for the ranking by
    shape."""
    from relation_tpu_torch.ops.kernels import bias_attention as K
    from relation_tpu_torch.ops.kernels.geom_bias import geom_bias_reference
    result = _check_bias_attention(torch, dev, rng, skip=False)
    G, D, E, C, N = 16, 64, 8, 80, 100
    pos, q, k, v, wg, bg, wl = attention_inputs(torch, dev, rng, C=C, N=N)
    bias = geom_bias_reference(pos, wg, bg).contiguous()
    got = K.fused_bias_attention(bias, q, k, v, wl)
    want = K.bias_attention_reference(bias, q, k, v, wl, None)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    ms = time_ms(torch, lambda: K.fused_bias_attention(bias, q, k, v, wl))
    plain_ms = time_ms(torch, lambda: K.bias_attention_reference(
        bias, q, k, v, wl, None), inner=2, reps=11)
    library_ms = sdpa_bias_ms(torch, bias, q, k, v, G, D)
    bms, bby, simt = bias_attention_bound(C, C, N, G, D, v.shape[2], E)
    log(f"[kernel] bias_attention C={C} N={N} active={C}: max abs err {err:.3e} "
        f"(tol {tol:.1e}) {'OK' if err <= tol else 'FAIL'}; kernel_ms {ms:.4f} "
        f"plain_ms {plain_ms:.4f} library_ms(SDPA core) {library_ms:.4f} "
        f"bound_us {bms * 1e3:.2f} ({bby}; all flops at the f32 rate: "
        f"{simt * 1e3:.2f})")
    if not err <= tol:
        fail("fused_bias_attention disagrees with its plain version at N=100")
    # above one key chunk (152 keys): three chunks and three blocks of query
    # rows joined by the online softmax, at 408, the largest N of the
    # learned-NMS widths before the chunked design; a stream of its own, so
    # that every later draw of rng stays as it was
    C, N = 4, 408
    pos, q, k, v, wg, bg, wl = attention_inputs(
        torch, dev, np.random.RandomState(11), C=C, N=N)
    bias = geom_bias_reference(pos, wg, bg).contiguous()
    got = K.fused_bias_attention(bias, q, k, v, wl)
    want = K.bias_attention_reference(bias, q, k, v, wl, None)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    ms = time_ms(torch, lambda: K.fused_bias_attention(bias, q, k, v, wl))
    bms, bby, _ = bias_attention_bound(C, C, N, G, D, v.shape[2], E)
    log(f"[kernel] bias_attention C={C} N={N} active={C} (three key chunks): "
        f"max abs err {err:.3e} (tol {tol:.1e}) {'OK' if err <= tol else 'FAIL'}; "
        f"kernel_ms {ms:.4f} bound_us {bms * 1e3:.2f} ({bby})")
    if not err <= tol:
        fail("fused_bias_attention disagrees with its plain version at N=408")
    return result


def check_bias_attention_skip(torch, dev, rng):
    """Row 8 with 16 of 80 classes active (the compact two-stage tail)."""
    return _check_bias_attention(torch, dev, rng, skip=True)


def check_attention_full(torch, dev, rng):
    """Row 6 over all 80 classes at the flagship's N=100, timed beside the
    two-stage route at the same inputs (row 1, then row 7)."""
    from relation_tpu_torch.ops.kernels import bias_attention as BA
    from relation_tpu_torch.ops.kernels import geom_bias as GB
    from relation_tpu_torch.ops.kernels import nms_attention as K
    C, N, G, D, Fd, E = 80, 100, 16, 64, 128, 8
    args = attention_inputs(torch, dev, rng)
    pos, q, k, v, wg, bg, wl = args
    got = K.fused_nms_relation_attention(*args)
    want = K.nms_relation_attention_reference(*args)
    again = K.fused_nms_relation_attention(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    same = torch.equal(got, again)
    ok = err <= tol and same and bool(torch.isfinite(got).all())
    ms = time_ms(torch, lambda: K.fused_nms_relation_attention(*args))
    plain_ms = time_ms(torch, lambda: K.nms_relation_attention_reference(*args))
    library_ms = sdpa_ms(torch, *args[:6], N, G, D, Fd)
    two_ms = time_ms(torch, lambda: BA.fused_bias_attention(
        GB.fused_geometric_bias(pos, wg, bg), q, k, v, wl))
    bms, bby, simt = attention_bound(C, C, N, G, D, Fd, E)
    log(f"[kernel] nms_attention_full C={C} N={N}: max abs err {err:.3e} "
        f"(tol {tol:.1e}), two runs bit-equal: {same}, {'OK' if ok else 'FAIL'}; "
        f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms(SDPA core) "
        f"{library_ms:.4f} two-stage_ms(row 1 + row 7) {two_ms:.4f} bound_us "
        f"{bms * 1e3:.2f} ({bby}; all flops at the f32 rate: {simt * 1e3:.2f})")
    if not ok:
        fail("fused_nms_relation_attention disagrees with its plain version")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=bby, library_ms=library_ms)


def check_nms_classic(torch, dev, rng, ran):
    """nms_keep_sorted at the shape of the classic detection tail: 80
    classes of 300 boxes padded to 512, each class stopping at 100 kept."""
    from relation_tpu_torch.ops.kernels import nms_kernel as K
    C, n, np_pad, block, max_keep, thresh = 80, 300, 512, 256, 100, 0.3
    bT = np.zeros((C, 4, np_pad), np.float32)
    valid = np.zeros((C, np_pad), np.float32)
    for c in range(C):
        # a few classes are crowded (12 clusters), most sparse, some short
        bT[c, :, :n] = random_boxes(rng, n, clusters=12 if c % 8 == 0 else 150).T
        valid[c, :n - (c % 5) * 40] = 1.0
    bT_t, v_t = torch.tensor(bT, device=dev), torch.tensor(valid, device=dev)

    def kernel():
        return K.nms_keep_sorted(bT_t, v_t, thresh, block, max_keep)
    got = kernel()
    want = K.nms_keep_sorted_reference(bT_t, v_t, thresh, block, max_keep)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    kept = want.sum(1).cpu().numpy()
    ok = (err == 0.0 and kept.max() >= max_keep and kept.min() < max_keep
          and len(ran) == 1 and "nms_kernel" in ran[0])
    ms = time_ms(torch, kernel)
    plain_ms = time_ms(torch, lambda: K.nms_keep_sorted_reference(
        bT_t, v_t, thresh, block, max_keep), inner=1, reps=7)
    keep_np = want.cpu().numpy()
    tests = sum(nms_tests(keep_np[c], valid[c], block, max_keep)[0]
                for c in range(C))
    log(f"[kernel] nms_keep_sorted C={C} Np={np_pad} t={thresh} max_keep={max_keep} "
        f"(classic tail): keep-mask mismatches {err:.0f} (tol 0) "
        f"{'OK' if ok else 'FAIL'}; kept per class {int(kept.min())}..{int(kept.max())}; "
        f"{len(ran)} kernel a call on the card; "
        f"IoU tests {tests}, modelled (two-pass design: "
        f"{C * np_pad * (np_pad - 1) // 2}); "
        f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms n/a")
    if not ok:
        fail("nms_keep_sorted (classic tail shape) disagrees with its plain "
             "version, or put more than one kernel on the card")


# the global-atomics col2im this kernel replaced, B=2 with bf16 rows, on an
# H100 80GB HBM3 at 700 W (PERF.md section 6)
ATOMICS_COL2IM_MS = 0.1078


def check_col2im(torch, dev, rng):
    """The col2im kernel against its plain version at B=1 and B=2 of the
    38x64 res5 map, bf16 and f32 rows, and at B=1 of a 100x64 map; every
    element written (the first launch writes into NaN), pixels out of every
    sample's reach exactly zero, two launches within 1e-5 of
    the largest element (the samples of a cell are summed in the order
    their atomic ranks give, spilled samples added by atomics). Then the
    res5 map at B=2 with samples crowded onto two objects (some spill past
    their cells' buckets), bf16 rows, in the same bands."""
    from relation_tpu_torch.ops.kernels import dconv_col2im as K
    from relation_tpu_torch.tools.ablate_col2im import (col2im_inputs,
                                                        crowded_inputs, spilled)
    W, G, cg = 64, 4, 128
    result = None
    for B, H in ((1, 38), (2, 38), (1, 100)):
        yz, xz, inside, d32 = col2im_inputs(torch, dev, rng, B, H=H)
        n_in = int(inside.sum())
        for d in (d32, d32.to(torch.bfloat16)):
            name = "bf16" if d.dtype == torch.bfloat16 else "f32"
            # into NaN: every element of dx must be written
            got = K._launch(yz, xz, inside, d, H, W, torch.full(
                (B, H, W, G * cg), float("nan"), device=dev))
            again = K._launch(yz, xz, inside, d, H, W)
            want = K.dconv_col2im_reference(yz, xz, inside, d, H, W)
            torch.cuda.synchronize()
            top = float(want.abs().max())
            err = float((got - want).abs().max())
            rerun = float((got - again).abs().max())
            # both sum the same f32 products in another order: 1e-5 of the
            # largest element (some 30 terms of size 1 a pixel)
            tol = 1e-5 * top
            untouched = bool((got[:, :3, :3] == 0).all()) and bool(
                (got[:, 3:, 3:] != 0).any())
            ok = (err <= tol and rerun <= tol and untouched
                  and bool(torch.isfinite(got).all()))
            ms = time_ms(torch, lambda: K._launch(yz, xz, inside, d, H, W))
            plain_ms = time_ms(torch, lambda: K.dconv_col2im_reference(
                yz, xz, inside, d, H, W), inner=2, reps=7)
            # the rows of the samples inside, the coordinates and the mask,
            # dx written once; 2 flops a corner a channel. The zero-fill
            # figure (dx zeroed, then written) is the bound of the
            # global-atomics design, printed beside it
            out_bytes = B * H * W * G * cg * 4
            in_bytes = n_in * cg * d.element_size() + yz.numel() * 9
            bms, bby = bound(in_bytes + out_bytes, 2 * 4 * n_in * cg, F32_PEAK)
            zfill_ms, _ = bound(in_bytes + 2 * out_bytes, 2 * 4 * n_in * cg,
                                F32_PEAK)
            vs = (f" (the global-atomics kernel: {ATOMICS_COL2IM_MS} ms)"
                  if (B, H, name) == (2, 38, "bf16") else "")
            log(f"[kernel] dconv_col2im B={B} BG={B * G} R={yz.shape[1]} {H}x{W} "
                f"cg={cg} D {name}: max abs err {err:.3e} of max {top:.3e} "
                f"(tol 1e-5 of max), two launches differ by {rerun:.3e}, untouched pixels zero: "
                f"{untouched}, {n_in} of {yz.numel()} samples inside, "
                f"{'OK' if ok else 'FAIL'}; kernel_ms {ms:.4f}{vs} plain_ms "
                f"{plain_ms:.4f} library_ms n/a bound_us {bms * 1e3:.2f} ({bby}; "
                f"with a zero fill {zfill_ms * 1e3:.2f})")
            if not ok:
                fail(f"dconv_col2im B={B} {H}x{W} {name} disagrees with its "
                     "plain version")
            if (B, H, name) == (2, 38, "bf16"):
                # what the DCN train step launches
                result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=bms, bound_by=bby, library_ms=None)
    label, (yz, xz, inside, d), H, W = crowded_inputs(torch, dev, rng)[0]
    d = d.to(torch.bfloat16)
    got = K._launch(yz, xz, inside, d, H, W, torch.full(
        (2, H, W, d.shape[2] * d.shape[3]), float("nan"), device=dev))
    again = K._launch(yz, xz, inside, d, H, W)
    want = K.dconv_col2im_reference(yz, xz, inside, d, H, W)
    torch.cuda.synchronize()
    top = float(want.abs().max())
    err = float((got - want).abs().max())
    rerun = float((got - again).abs().max())
    over, reach, most = spilled(yz, xz, inside, H, W)
    ok = err <= 1e-5 * top and rerun <= 1e-5 * top and over > 0
    ms = time_ms(torch, lambda: K._launch(yz, xz, inside, d, H, W))
    log(f"[kernel] dconv_col2im {label} D bf16: {over} of {reach} samples "
        f"spilled (at most {most} a cell), max abs err {err:.3e} of max {top:.3e} "
        f"(tol 1e-5 of max), two launches differ by {rerun:.3e}, "
        f"{'OK' if ok else 'FAIL'}; kernel_ms {ms:.4f}")
    if not ok:
        fail(f"dconv_col2im on crowded samples: disagrees with its plain version "
             f"or nothing spilled ({over})")
    return result


def roi_pool_bound(K, feat, rois, scale, P=7, argmax=False):
    """(bound_ms, bound_by) of one ROIPooling forward: the map read once,
    the ROIs, the pooled values written once (and their int32 argmax, with
    ``argmax``: the training forward); a comparison an element of every bin
    of these ROIs at the f32 rate."""
    H, W, C = feat.shape
    R = rois.shape[0]
    hs, he, ws, we = K.roi_pool_bins(rois, scale, P, H, W)
    cells = float(((he - hs)[:, :, None] * (we - ws)[:, None, :]).sum())
    nbytes = (H * W * C * feat.element_size() + R * 16
              + R * P * P * C * (feat.element_size() + (4 if argmax else 0)))
    return bound(nbytes, cells * C, F32_PEAK)


def check_roi_pool(torch, dev, rng):
    """Exact ROIPooling (no Pallas counterpart: the JAX function is plain
    jnp). First the bin arithmetic's division on the card: n / d of two
    CUDA tensors for every n up to 4096 and the divisors 1, 2, 3, 6, 7, 14,
    bit-equal to the CPU's IEEE division (a CUDA tensor divided by a host
    scalar is multiplied by the reciprocal; the count of the quotients that
    differs is printed). Then the kernel against its plain version at the
    C4 head's shape (300 proposals of a 600x1000 image on the 38x64x256
    map, 1/16) in f32 and bf16, at the portrait bucket's (300 proposals of
    an 800x600 image on the 50x64x256 map) in bf16, and at the four FPN
    levels of a 608x1024 image (152x256 .. 19x32, 256 channels) with the
    ROIs of 1000 proposals dispatched there, bf16: values and argmax equal
    (maxima of the inputs, the first in scan order), the inference forward
    (no argmax) bit-equal to the training forward, the backward's f32
    atomics within 1e-5 of the plain gradient's largest element (the plain
    version summing the same cotangent, rounded to feat's dtype; bf16: the
    kernel's sum, rounded once, within one bf16 step of the plain sum).
    Times the inference forward, the training forward (with the argmax,
    against its own bound), the backward and the plain version at each
    shape; the JSON row is the C4 head's bf16 inference forward, the one
    pred_eval launches."""
    from relation_tpu_torch.models.fpn import DISPATCH_STRIDES, roi_level_dispatch
    from relation_tpu_torch.ops.kernels import roi_pool as K
    num = torch.arange(1, 4097, device=dev)
    for d in (1, 2, 3, 6, 7, 14):
        if not torch.equal(K.f32_div(num, d).cpu(), K.f32_div(num.cpu(), d)):
            fail(f"roi_pool: f32 division by {d} on the card is not IEEE-exact")
    recip = int(((num.float() / 7.0).cpu() != K.f32_div(num.cpu(), 7)).sum())
    log(f"[kernel] roi_pool f32_div: n / d of two CUDA tensors bit-equal to the "
        f"CPU's for n <= 4096, d in (1, 2, 3, 6, 7, 14); a CUDA tensor / 7.0 "
        f"(host scalar) differs at {recip} of 4096")
    cases = [("C4 head", 38, 64, 1.0 / 16, random_boxes(rng, 300), dt)
             for dt in (torch.float32, torch.bfloat16)]
    cases.append(("C4 head, portrait", 50, 64, 1.0 / 16,
                  random_boxes(rng, 300, im_w=600.0, im_h=800.0), torch.bfloat16))
    # proposals of 16 to 900 px a side, so that every level gets some
    c = rng.uniform([0, 0], [1000, 600], (1000, 2))
    wh = np.exp(rng.uniform(np.log(16), np.log(900), (1000, 2)))
    b = np.concatenate([c - wh / 2, c + wh / 2], 1)
    b[:, 0::2] = b[:, 0::2].clip(0, 999)
    b[:, 1::2] = b[:, 1::2].clip(0, 599)
    props = torch.tensor(b.astype(np.float32), device=dev)
    fid = roi_level_dispatch(props)
    for i, s in enumerate(DISPATCH_STRIDES):
        cases.append((f"FPN P{i + 2}", 608 // s, 1024 // s, 1.0 / s,
                      props[fid == i].cpu().numpy(), torch.bfloat16))
    result = None
    for label, H, W, scale, boxes, dt in cases:
        feat = torch.tensor(rng.randn(H, W, 256).astype(np.float32),
                            device=dev).to(dt)
        rois = torch.tensor(np.asarray(boxes, np.float32), device=dev)
        cot = torch.tensor(rng.randn(len(boxes), 7, 7, 256).astype(np.float32),
                           device=dev)
        f = feat.clone().requires_grad_()
        got = K.roi_pool(f, rois, scale, 7)
        (got.float() * cot).sum().backward()
        # the kernel's cotangent arrives in feat's dtype: the plain version
        # sums the same values, in f32
        ref = feat.float().clone().requires_grad_()
        want = K.roi_pool_reference(ref, rois, scale, 7)
        (want * cot.to(dt).float()).sum().backward()
        got, want = got.detach(), want.detach()
        _, k_arg = K._launch(feat, rois, scale, 7)
        p_arg = K.roi_pool_argmax_reference(feat, rois, scale, 7)
        infer, _ = K._launch(feat, rois, scale, 7, with_argmax=False)
        torch.cuda.synchronize()
        err = float((got.float() - want).abs().max())
        arg_ok = bool(torch.equal(k_arg.long(), p_arg))
        infer_ok = bool(torch.equal(infer, got))
        top = float(ref.grad.abs().max())
        if dt == torch.float32:
            g_err = float((f.grad - ref.grad).abs().max())
            g_ok = g_err <= 1e-5 * top
        else:
            g = ref.grad.to(dt).float()
            g_err = float((f.grad.float() - g).abs().max())
            g_ok = bool(((f.grad.float() - g).abs() <= g.abs() * 2.0 ** -7).all())
        ok = err == 0 and arg_ok and g_ok and infer_ok
        name = "bf16" if dt == torch.bfloat16 else "f32"
        ms = time_ms(torch, lambda: K._launch(feat, rois, scale, 7,
                                              with_argmax=False))
        train_ms = time_ms(torch, lambda: K._launch(feat, rois, scale, 7))
        argmax = k_arg
        bwd_ms = time_ms(torch, lambda: K._launch_bwd(cot.to(dt), argmax, H, W))
        plain_ms = time_ms(torch, lambda: K.roi_pool_reference(feat, rois,
                                                               scale, 7),
                           inner=2, reps=7)
        bms, bby = roi_pool_bound(K, feat, rois, scale)
        tbms, tbby = roi_pool_bound(K, feat, rois, scale, argmax=True)
        log(f"[kernel] roi_pool {label} R={len(boxes)} {H}x{W}x256 {name}: max "
            f"abs err {err:.3e}, argmax equal {arg_ok}, inference forward "
            f"equal {infer_ok}, grad max abs err {g_err:.3e} of max {top:.3e}, "
            f"{'OK' if ok else 'FAIL'}; kernel_ms {ms:.4f} (no argmax, bound_us "
            f"{bms * 1e3:.2f} {bby}) train_fwd_ms {train_ms:.4f} (argmax, "
            f"bound_us {tbms * 1e3:.2f} {tbby}) bwd_ms {bwd_ms:.4f} plain_ms "
            f"{plain_ms:.4f} library_ms none")
        if not ok:
            fail(f"roi_pool {label} {name} disagrees with its plain version")
        if label == "C4 head" and dt == torch.bfloat16:
            result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bms, bound_by=bby, library_ms=None)
    return result


def jitter_bn(torch, model, rng) -> None:
    """Non-trivial frozen-BN statistics (init_params leaves BN at identity,
    which would hide a fold that mixes up its scale and its shift)."""
    with torch.no_grad():
        for name, buf in model.named_buffers():
            leaf, shape = name.rsplit(".", 1)[-1], tuple(buf.shape)
            if leaf == "moving_var":
                r = rng.uniform(0.5, 2.0, shape)
            elif leaf in ("moving_mean", "beta"):
                r = rng.randn(*shape) * 0.1
            elif leaf == "gamma":
                r = rng.uniform(0.8, 1.2, shape)
            else:
                continue
            r = torch.tensor(r, dtype=torch.float32, device=buf.device)
            buf.add_(r) if leaf in ("moving_mean", "beta") else buf.mul_(r)


def seeded_c4(torch, dev, seed: int = 21):
    """A bf16 ResNet101C4 on the card with lecun-normal conv weights and
    jittered BN, its convs computing in bf16 (build_model's policy)."""
    from relation_tpu_torch.models.backbone import Conv2d, ResNet101C4
    rng = np.random.RandomState(seed)
    c4 = ResNet101C4(dtype=torch.bfloat16).to(dev).eval()
    with torch.no_grad():
        for p in c4.parameters():
            p.copy_(torch.tensor(rng.randn(*p.shape) / np.sqrt(p[0].numel()),
                                 dtype=torch.float32))
    jitter_bn(torch, c4, rng)
    for m in c4.modules():
        if isinstance(m, Conv2d):
            m.compute_dtype = torch.bfloat16
    return c4


# stage -> (identity blocks, [H, W] of its map, Cin of its first block, Cmid,
# C, stride of its first block) at 608x1024
TRUNK = {2: (2, (152, 256), 64, 64, 256, 1), 3: (3, (76, 128), 256, 128, 512, 2),
         4: (22, (38, 64), 512, 256, 1024, 2)}


def _band(torch, got, want):
    """(max abs error, its share of max |want|, correlation)."""
    got, want = got.float().flatten(), want.float().flatten()
    err = float((got - want).abs().max())
    corr = float(torch.corrcoef(torch.stack([got, want]))[0, 1])
    return err, err / float(want.abs().max()), corr


def _cl(t):
    """A conv weight [O, I, kh, kw] in channels_last bf16, made once."""
    import torch
    return t.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)


def folded_stack_chain(torch, stack):
    """The stack's exact function as cuDNN calls on its folded bf16 weights:
    per block F.conv2d with bias (1x1, 3x3 padded, 1x1), ReLU, residual add,
    on a channels_last [1, C, H, W] map. A yardstick only: the port never
    calls it."""
    import torch.nn.functional as F
    wa, b1, w3, b2, wc, b3 = stack
    Cmid = wa.shape[2]
    bf = torch.bfloat16
    layers = [(_cl(wa[i].t()[:, :, None, None]), b1[i].to(bf),
               _cl(w3[i].reshape(3, 3, Cmid, Cmid).permute(3, 2, 0, 1)),
               b2[i].to(bf), _cl(wc[i].t()[:, :, None, None]), b3[i].to(bf))
              for i in range(wa.shape[0])]

    def run(x):
        for ka, ba, k3, bb, kc, bc in layers:
            y = F.conv2d(x, ka, ba).relu_()
            y = F.conv2d(y, k3, bb, padding=1).relu_()
            x = F.conv2d(y, kc, bc).add_(x).relu_()
        return x
    return run


def folded_proj_chain(torch, proj, s):
    """The projection block's exact function as cuDNN calls on its folded
    bf16 weights (channels_last, stride s on the two 1x1 convs of x)."""
    import torch.nn.functional as F
    w1, b1p, wa, b1, w3, b2, wc, b3 = proj
    Cmid = wa.shape[1]
    bf = torch.bfloat16
    k1, ka = _cl(w1.t()[:, :, None, None]), _cl(wa.t()[:, :, None, None])
    k3 = _cl(w3.reshape(3, 3, Cmid, Cmid).permute(3, 2, 0, 1))
    kc = _cl(wc.t()[:, :, None, None])
    bs = [t.to(bf) for t in (b1p, b1, b2, b3)]

    def run(x):
        sc = F.conv2d(x, k1, bs[0], stride=s)
        y = F.conv2d(x, ka, bs[1], stride=s).relu_()
        y = F.conv2d(y, k3, bs[2], padding=1).relu_()
        return F.conv2d(y, kc, bs[3]).add_(sc).relu_()
    return run


def check_stack(torch, dev, rng):
    from relation_tpu_torch.models.backbone import fold_trunk_params
    from relation_tpu_torch.ops.kernels import res4 as K
    c4 = seeded_c4(torch, dev)
    folds = fold_trunk_params(c4)
    result = None
    for stage in (4, 3, 2):
        B, (H, W), _, Cmid, C, _ = TRUNK[stage]
        stack = folds[stage]["stack"]
        x = torch.tensor(np.maximum(rng.randn(H, W, C), 0) * 2.0,
                         dtype=torch.bfloat16, device=dev)
        x0 = x.clone()
        got = K._launch(x, *stack)
        want = K.bottleneck_stack_reference(x, *stack)
        units = c4.units(stage)[1:]
        xn = x.permute(2, 0, 1)[None].contiguous()

        def library():
            y = xn
            for u in units:
                y = u(y)
            return y
        folded = folded_stack_chain(torch, stack)
        xcl = x.permute(2, 0, 1)[None]   # NHWC in memory: channels_last
        with torch.inference_mode():
            lib = library()[0].permute(1, 2, 0)
            flib = folded(xcl)[0].permute(1, 2, 0)
        torch.cuda.synchronize()
        err, rel, corr = _band(torch, got, want)
        _, lib_rel, lib_corr = _band(torch, lib, want)
        _, flib_rel, flib_corr = _band(torch, flib, want)
        # both sum exact bf16 products in f32 in other orders and round y1,
        # y2 and every block's output to bf16: an element one bf16 step
        # apart travels through the later blocks
        ok = (rel <= 2e-2 and corr > 0.9999 and torch.equal(x, x0)
              and bool(torch.isfinite(got.float()).all()))
        ms = time_ms(torch, lambda: K._launch(x, *stack), inner=5, reps=11)
        plain_ms = time_ms(torch, lambda: K.bottleneck_stack_reference(x, *stack),
                           inner=1, reps=5)
        with torch.inference_mode():
            library_ms = time_ms(torch, library, inner=2, reps=7)
            folded_ms = time_ms(torch, lambda: folded(xcl), inner=2, reps=7)
        R = H * W
        wbytes = B * (2 * (2 * C * Cmid + 9 * Cmid * Cmid) + 4 * (2 * Cmid + C))
        bms, bby = bound(2 * R * C * 2 + wbytes,
                         2 * B * R * (2 * C * Cmid + 9 * Cmid * Cmid), BF16_PEAK)
        log(f"[kernel] fused_bottleneck_stack res{stage} B={B} [{H},{W},{C}] "
            f"Cmid={Cmid}: max abs err {err:.3e} = {rel:.2e} of max (tol 2e-2), "
            f"corr {corr:.7f} (tol 0.9999), input unchanged: {torch.equal(x, x0)}, "
            f"{'OK' if ok else 'FAIL'}; cuDNN chain vs plain {lib_rel:.2e} of max, "
            f"corr {lib_corr:.7f}; folded cuDNN chain vs plain {flib_rel:.2e} of "
            f"max, corr {flib_corr:.7f}; kernel_ms {ms:.4f} (1 launch + 1 memset) "
            f"plain_ms {plain_ms:.4f} library_ms(cuDNN chain, Bottleneck modules) "
            f"{library_ms:.4f} library_ms(cuDNN chain, folded channels_last) "
            f"{folded_ms:.4f}; kernel below both: {ms < min(library_ms, folded_ms)}; "
            f"bound_us {bms * 1e3:.2f} ({bby})")
        if not ok:
            fail(f"fused_bottleneck_stack res{stage} disagrees with its plain version")
        if stage == 4:   # held to the faster yardstick
            result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                          bound_by=bby, library_ms=min(library_ms, folded_ms))
    del c4, folds
    return result   # res4b1..b22, the stack that TPU.FUSE_RES4 runs


def check_proj(torch, dev, rng):
    from relation_tpu_torch.models.backbone import fold_trunk_params
    from relation_tpu_torch.ops.kernels import bottleneck_proj as K
    c4 = seeded_c4(torch, dev)
    folds = fold_trunk_params(c4)
    result = None
    for stage in (4, 3, 2):
        _, (H, W), Cin, Cmid, Cout, s = TRUNK[stage]
        proj = folds[stage]["proj"]
        x = torch.tensor(np.maximum(rng.randn(H * s, W * s, Cin), 0) * 2.0,
                         dtype=torch.bfloat16, device=dev)
        got = K._launch(x, *proj, s)
        want = K.proj_bottleneck_reference(x, *proj, stride=s)
        unit = c4.units(stage)[0]
        xn = x.permute(2, 0, 1)[None].contiguous()
        folded = folded_proj_chain(torch, proj, s)
        xcl = x.permute(2, 0, 1)[None]   # NHWC in memory: channels_last
        with torch.inference_mode():
            lib = unit(xn)[0].permute(1, 2, 0)
            flib = folded(xcl)[0].permute(1, 2, 0)
        torch.cuda.synchronize()
        err, rel, corr = _band(torch, got, want)
        _, lib_rel, lib_corr = _band(torch, lib, want)
        _, flib_rel, flib_corr = _band(torch, flib, want)
        ok = rel <= 2.0 ** -7 and corr > 0.9999 and bool(
            torch.isfinite(got.float()).all())
        ms = time_ms(torch, lambda: K._launch(x, *proj, s))
        plain_ms = time_ms(torch, lambda: K.proj_bottleneck_reference(
            x, *proj, stride=s), inner=2, reps=7)
        with torch.inference_mode():
            library_ms = time_ms(torch, lambda: unit(xn))
            folded_ms = time_ms(torch, lambda: folded(xcl))
        R = H * W
        wbytes = 2 * (Cin * Cout + Cin * Cmid + 9 * Cmid * Cmid + Cmid * Cout) \
            + 4 * (2 * Cout + 2 * Cmid)
        # the rows the stride keeps are all the function reads of x
        bms, bby = bound(R * Cin * 2 + R * Cout * 2 + wbytes,
                         2 * R * (Cin * Cout + Cin * Cmid + 9 * Cmid * Cmid
                                  + Cmid * Cout), BF16_PEAK)
        log(f"[kernel] fused_proj_bottleneck res{stage}a [{H * s},{W * s},{Cin}] "
            f"-> [{H},{W},{Cout}] s={s} Cmid={Cmid}: max abs err {err:.3e} = "
            f"{rel:.2e} of max (tol 2^-7), corr {corr:.7f} (tol 0.9999) "
            f"{'OK' if ok else 'FAIL'}; cuDNN block vs plain {lib_rel:.2e} of "
            f"max, corr {lib_corr:.7f}; folded cuDNN block vs plain {flib_rel:.2e} "
            f"of max, corr {flib_corr:.7f}; kernel_ms {ms:.4f} (1 launch + 1 "
            f"memset) plain_ms {plain_ms:.4f} library_ms(cuDNN block, Bottleneck "
            f"module) {library_ms:.4f} library_ms(cuDNN block, folded "
            f"channels_last) {folded_ms:.4f}; bound_us {bms * 1e3:.2f} ({bby})")
        if not ok:
            fail(f"fused_proj_bottleneck res{stage}a disagrees with its plain version")
        if stage == 4:   # held to the faster yardstick
            result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                          bound_by=bby, library_ms=min(library_ms, folded_ms))
    del c4, folds
    return result   # res4a, the block before the stack


# --------------------------------------------------------------------------
# phases 3-4: the flagship through the port's entry points
# --------------------------------------------------------------------------

# name in the JSON line -> (module of relation_tpu_torch.ops.kernels, counter)
COUNTERS = {"geom_bias": ("geom_bias", "launches"),
            "nms_keep_sorted": ("nms_kernel", "launches"),
            "stem_conv1_bn_relu": ("stem", "launches"),
            "fused_nms_relation_attention_skip": ("nms_attention", "launches"),
            "geom_bias_bwd": ("geom_bias", "bwd_launches"),
            "fused_nms_relation_attention": ("nms_attention", "full_launches"),
            "dconv_col2im": ("dconv_col2im", "launches"),
            "fused_bottleneck_stack": ("res4", "launches"),
            "fused_proj_bottleneck": ("bottleneck_proj", "launches"),
            "fused_geometric_bias_skip": ("geom_bias", "skip_launches"),
            "fused_bias_attention": ("bias_attention", "launches"),
            "fused_bias_attention_skip": ("bias_attention", "skip_launches"),
            "roi_pool": ("roi_pool", "launches")}
# name in the JSON line -> (module, dict of its launches by shape): the rows
# whose launches mix shapes, so that launches x (ms - bound) splits by shape
SHAPES = {"geom_bias": ("geom_bias", "launch_shapes"),
          "nms_keep_sorted": ("nms_kernel", "launch_shapes"),
          "geom_bias_bwd": ("geom_bias", "bwd_launch_shapes"),
          "fused_bias_attention": ("bias_attention", "launch_shapes"),
          "fused_nms_relation_attention_skip": ("nms_attention", "launch_shapes"),
          "roi_pool": ("roi_pool", "launch_shapes")}
INFERENCE_KERNELS = ("geom_bias", "nms_keep_sorted", "stem_conv1_bn_relu",
                     "fused_nms_relation_attention_skip", "fused_bias_attention")


def _counter(name):
    import importlib
    mod, attr = COUNTERS[name]
    return importlib.import_module(f"relation_tpu_torch.ops.kernels.{mod}"), attr


def read_counter(name) -> int:
    mod, attr = _counter(name)
    return getattr(mod, attr)


def _shapes(name) -> dict:
    import importlib
    mod, attr = SHAPES[name]
    return getattr(importlib.import_module(
        f"relation_tpu_torch.ops.kernels.{mod}"), attr)


def read_launches(names=COUNTERS) -> dict:
    """The launch counters of ``names``, and for the rows of SHAPES their
    launches by shape under "name@shape"."""
    out = {k: read_counter(k) for k in names}
    for k in SHAPES:
        if k in names:
            out.update({f"{k}@{s}": n for s, n in _shapes(k).items()})
    return out


def zero_counters() -> None:
    for name in COUNTERS:
        mod, attr = _counter(name)
        setattr(mod, attr, 0)
    for name in SHAPES:
        _shapes(name).clear()


@contextlib.contextmanager
def plain_kernels():
    """Route the model's kernel calls to their plain versions, which autograd
    differentiates (this harness's comparison only; the port itself
    dispatches by device)."""
    import relation_tpu_torch.models.backbone as bb
    import relation_tpu_torch.models.detector as det
    import relation_tpu_torch.models.fpn as fpn
    import relation_tpu_torch.models.relation as rel
    import relation_tpu_torch.ops.deform as deform
    import relation_tpu_torch.ops.nms as nms
    from relation_tpu_torch.ops.kernels import (bias_attention, bottleneck_proj,
                                                dconv_col2im, geom_bias,
                                                nms_attention, nms_kernel, res4,
                                                roi_pool, stem)
    swaps = [(deform, "dconv_col2im", dconv_col2im.dconv_col2im_reference),
             (det, "roi_pool", roi_pool.roi_pool_reference),
             (fpn, "roi_pool", roi_pool.roi_pool_reference),
             (bb, "fused_bottleneck_stack", res4.bottleneck_stack_reference),
             (bb, "fused_proj_bottleneck", bottleneck_proj.proj_bottleneck_reference),
             (bb, "stem_conv1_bn_relu",
              lambda x, w4, s, b: stem.stem_reference(x, w4, s, b)),
             (rel, "fused_geometric_bias", geom_bias.geom_bias_reference),
             (rel, "fused_geometric_bias_skip", geom_bias.geom_bias_skip_reference),
             (rel, "fused_bias_attention", bias_attention.bias_attention_reference),
             (rel, "fused_bias_attention_skip",
              bias_attention.bias_attention_reference),
             (rel, "fused_nms_relation_attention_skip",
              nms_attention.nms_relation_attention_reference),
             (rel, "fused_nms_relation_attention",
              lambda *a: nms_attention.nms_relation_attention_reference(
                  *a[:7], None, *a[7:])),
             (nms, "nms_keep_sorted", nms_kernel.nms_keep_sorted_reference)]
    saved = [(m, a, getattr(m, a)) for m, a, _ in swaps]
    for m, a, f in swaps:
        setattr(m, a, f)
    try:
        yield
    finally:
        for m, a, f in saved:
            setattr(m, a, f)


def iou(a, b):
    ix = np.maximum(0, np.minimum(a[2], b[:, 2]) - np.maximum(a[0], b[:, 0]) + 1)
    iy = np.maximum(0, np.minimum(a[3], b[:, 3]) - np.maximum(a[1], b[:, 1]) + 1)
    inter = ix * iy
    ua = ((a[2] - a[0] + 1) * (a[3] - a[1] + 1)
          + (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1) - inter)
    return inter / np.maximum(ua, 1e-9)


def match_dets(ref, new):
    """Band check of tools/flagship_golden.py; returns a list of errors."""
    ref = ref[ref[:, 0] >= 0]
    new = new[new[:, 0] >= 0]
    errs = []
    for i, g in enumerate(ref[np.argsort(-ref[:, 1], kind="stable")][:TOP_K]):
        same = new[new[:, 0] == g[0]]
        if not len(same):
            errs.append(f"top-{i}: class {int(g[0])} vanished")
            continue
        ious = iou(g[2:6], same[:, 2:6])
        j = int(np.argmax(ious))
        if ious[j] < IOU_MIN:
            errs.append(f"top-{i} cls {int(g[0])}: best IoU {ious[j]:.3f}")
        elif abs(same[j, 1] - g[1]) > SCORE_ATOL:
            errs.append(f"top-{i} cls {int(g[0])}: score {same[j, 1]:.4f} vs {g[1]:.4f}")
    return errs


def with_active(make, model, cfg, out, k: int):
    """A predict function (``make(model, cfg)``) whose learned-NMS class
    threshold lets exactly k classes through on the request that gave
    ``out``: halfway between the k-th and the (k+1)-th largest class maximum
    of its sorted scores (the head's class filter, relation.py:224)."""
    m = np.sort(out["sorted_score"].max(0).values.cpu().numpy())[::-1]
    c = cfg.copy()
    c.TEST.LEARN_NMS_CLASS_SCORE_TH = float((m[k - 1] + m[k]) / 2)
    return make(model, c)


def run_flagship(torch, dev, n_images: int = 2, n_active: int = 16,
                 tiny: bool = False):
    """The flagship requests, kernel path then plain path. ``tiny`` (a
    rehearsal on the CPU) takes the tiny trunk and a 64x128 image."""
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.predictor import make_predict_fn
    from relation_tpu_torch.core.trainer import build_model
    from relation_tpu_torch.entry import BUCKET, flagship_cfg
    from relation_tpu_torch.ops.kernels import nms_attention
    counters = {k: COUNTERS[k] for k in INFERENCE_KERNELS}
    cfg = flagship_cfg(tiny_shapes=tiny)
    if tiny:
        # the tiny trunk's random head scores sit below the 1e-3 floor
        cfg.TEST.SCORE_THRESH = 0.0
    t0 = time.perf_counter()
    model = init_params(build_model(cfg, tiny=tiny, device=dev), seed=0)
    torch.cuda.synchronize()
    log(f"[e2e] flagship built: {sum(p.numel() for p in model.parameters())} "
        f"params, trunk {model.conv_dtype}, head f32, "
        f"{time.perf_counter() - t0:.1f} s")
    H, W = (64, 128) if tiny else BUCKET
    images = [torch.tensor(np.random.RandomState(7 + i).randn(12, H // 2, W // 2)
                           * 40.0, dtype=torch.float32, device=dev)
              for i in range(n_images)]
    im_info = torch.tensor([600.0, 1000.0, 1.667], device=dev)
    predict = make_predict_fn(model, cfg)

    # the class filter threshold picks the learned-NMS branch per request
    # (relation.py:224): the default 0.01 lets the data decide; two more
    # requests on image 0 fix it, 56 active classes (> C/2: the dense path,
    # geometric bias + bias attention) and n_active (<= C/2: the skip kernel)
    out0 = predict(images[0], im_info)                 # warm-up
    reqs = [(f"image {i}", predict, img) for i, img in enumerate(images)]
    reqs += [("dense, 56 active", with_active(make_predict_fn, model, cfg, out0, 56),
              images[0]),
             (f"skip, {n_active} active",
              with_active(make_predict_fn, model, cfg, out0, n_active), images[0])]
    for _, fn, img in reqs[-2:]:
        fn(img, im_info)                                # warm-up
    torch.cuda.synchronize()

    def run(record_branch):
        outs, times, labels = [], [], []
        for label, fn, img in reqs:
            skips = nms_attention.launches
            t1 = time.perf_counter()
            o = fn(img, im_info)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
            outs.append(o["dets"].cpu().numpy())
            if record_branch:
                label += " [skip]" if nms_attention.launches > skips else " [dense]"
            labels.append(f"{label}: {times[-1]:.3f} ms")
        return outs, times, labels

    zero_counters()
    outs, times, labels = run(True)
    launches = read_launches(counters)
    n_dets = [int((d[:, 0] >= 0).sum()) for d in outs]
    log(f"[e2e] kernel path: {'; '.join(labels)}; median ms/image of the "
        f"{n_images} default requests {statistics.median(times[:n_images]):.3f}; "
        f"detections {n_dets}; launches {launches}")
    if not (labels[-2].split(":")[0].endswith("[dense]")
            and labels[-1].split(":")[0].endswith("[skip]")):
        fail("the fixed-branch requests did not take their branches")
    for d in outs:
        if not np.isfinite(d).all() or d.shape != (int(cfg.TEST.max_per_image), 6):
            fail(f"bad detections: shape {d.shape}, finite {np.isfinite(d).all()}")
    if min(n_dets) == 0:
        fail("a request returned no detections")
    # the tiny trunk of a rehearsal has no conv1 stem
    zero = [k for k, v in launches.items()
            if v <= 0 and not (tiny and k == "stem_conv1_bn_relu")]
    if zero:
        fail(f"kernels never launched on the main path: {zero}")

    with plain_kernels():
        zero_counters()
        plain_outs, plain_times, plain_labels = run(False)
        stray = {k: read_counter(k) for k in COUNTERS if read_counter(k)}
    if stray:
        fail(f"plain run launched kernels: {stray}")
    errs = []
    for (label, _, _), ref, new in zip(reqs, plain_outs, outs):
        errs += [f"{label}: {e}" for e in match_dets(ref, new)]
    log(f"[e2e] plain path: {'; '.join(plain_labels)}; kernel vs plain "
        f"top-{TOP_K} (IoU>={IOU_MIN}, |ds|<={SCORE_ATOL}): "
        f"{'OK' if not errs else f'{len(errs)} mismatches'}")
    if errs:
        for e in errs[:20]:
            log(f"  {e}")
        fail("kernel path outside the flagship bands of the plain path")
    times = times[:n_images]
    return launches, statistics.median(times)


def run_dcn_inference(torch, dev, card: str = "", tiny: bool = False):
    """The DCN family at inference: two dcn_learn_nms requests and one
    dcn_relation request (classic per-class NMS tail), kernel path then
    plain path, offsets seeded away from zero. Returns (launch counts summed
    over the two models, median ms/image of the dcn_learn_nms requests)."""
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.predictor import make_predict_fn
    from relation_tpu_torch.core.trainer import build_model
    from relation_tpu_torch.entry import BUCKET, family_cfg
    from relation_tpu_torch.tools.calibrate import seed_offsets
    H, W = (64, 128) if tiny else BUCKET
    images = [torch.tensor(np.random.RandomState(7 + i).randn(12, H // 2, W // 2)
                           * 40.0, dtype=torch.float32, device=dev)
              for i in range(2)]
    im_info = torch.tensor([600.0, 1000.0, 1.667], device=dev)
    total = {k: 0 for k in COUNTERS}
    ms_image = None
    for family, imgs in (("dcn_learn_nms", images), ("dcn_relation", images[:1])):
        cfg = family_cfg(family, tiny_shapes=tiny)
        if tiny:
            cfg.TEST.SCORE_THRESH = 0.0
        model = init_params(build_model(cfg, tiny=tiny, device=dev), seed=0)
        seed_offsets(model, cfg, imgs[0], im_info)
        predict = make_predict_fn(model, cfg)
        predict(imgs[0], im_info)                       # warm-up
        torch.cuda.synchronize()

        def run():
            outs, times = [], []
            for img in imgs:
                t1 = time.perf_counter()
                o = predict(img, im_info)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
                outs.append(o["dets"].cpu().numpy())
            return outs, times
        zero_counters()
        outs, times = run()
        launches = read_launches()
        n_dets = [int((d[:, 0] >= 0).sum()) for d in outs]
        log(f"[e2e {family}] kernel path: ms/image "
            f"{', '.join(f'{x:.3f}' for x in times)}; detections {n_dets}; "
            f"launches {launches}; on {card}")
        for d in outs:
            if not np.isfinite(d).all() or d.shape != (int(cfg.TEST.max_per_image), 6):
                fail(f"{family}: bad detections: shape {d.shape}")
        if min(n_dets) == 0:
            fail(f"{family}: a request returned no detections")
        must = ["geom_bias", "nms_keep_sorted"] + ([] if tiny else ["stem_conv1_bn_relu"])
        # the classic tail is one more NMS launch a request, over 80 classes
        if family == "dcn_relation" and launches["nms_keep_sorted"] < 2 * len(imgs):
            fail("the classic tail did not launch nms_keep_sorted")
        zero = [k for k in must if launches[k] <= 0]
        if zero:
            fail(f"{family}: kernels never launched: {zero}")
        with plain_kernels():
            zero_counters()
            plain_outs, plain_times = run()
            stray = {k: read_counter(k) for k in COUNTERS if read_counter(k)}
        if stray:
            fail(f"{family}: plain run launched kernels: {stray}")
        errs = []
        for i, (ref, new) in enumerate(zip(plain_outs, outs)):
            errs += [f"image {i}: {e}" for e in match_dets(ref, new)]
        log(f"[e2e {family}] plain path: ms/image "
            f"{', '.join(f'{x:.3f}' for x in plain_times)}; kernel vs plain "
            f"top-{TOP_K} (IoU>={IOU_MIN}, |ds|<={SCORE_ATOL}): "
            f"{'OK' if not errs else f'{len(errs)} mismatches'}")
        if errs:
            for e in errs[:20]:
                log(f"  {e}")
            fail(f"{family}: kernel path outside the bands of the plain path")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        if family == "dcn_learn_nms":
            ms_image = statistics.median(times)
        del model, predict
    return total, ms_image


# --------------------------------------------------------------------------
# phases 8-9: the fused trunk
# --------------------------------------------------------------------------

def run_fused_flagship(torch, dev, card: str = "", n_images: int = 2,
                       tiny: bool = False):
    """The flagship served through entry() with TPU.FUSE_RES4 and BN
    statistics jittered from a seed: res4b1..b22 run as the stack kernel on
    the folds kept with the model (prediction layers calibrated,
    ``calibrate_heads``). The plain path computes its own c4 feature, held
    to the kernel path's (max error 3e-2 of the largest element,
    correlation 0.9999, the stack check's band), then continues from the
    kernel path's c4 feature, and its detections are held to the kernel
    path's in the bands of phase 4. From its own c4 feature the plain path's
    detections are printed, not held: a random-weight detector's proposals,
    per-class first-N cut and top-100 cut are discontinuous in the feature,
    and bf16 trunks that are each right (the fused one, the conv one, the
    plain versions) keep different boxes (PERF.md, section 6). The fused c4
    feature is also held against the conv trunk's (correlation 0.999).
    ``tiny`` (a rehearsal on the CPU) cuts the proposal counts and the image
    to 64x128; the trunk stays full depth. Returns (launches, median
    ms/image, the model)."""
    from relation_tpu_torch.entry import BUCKET, entry, family_cfg
    from relation_tpu_torch.tools.calibrate import calibrate_heads
    cfg = family_cfg("flagship", tiny_shapes=tiny)
    cfg.TPU.FUSE_RES4 = True
    if tiny:
        cfg.TEST.SCORE_THRESH = 0.0
    predict, _ = entry(device=dev, cfg=cfg)
    model = predict.model
    jitter_bn(torch, model, np.random.RandomState(5))
    H, W = (64, 128) if tiny else BUCKET
    images = [torch.tensor(np.random.RandomState(17 + i).randn(12, H // 2, W // 2)
                           * 40.0, dtype=torch.float32, device=dev)
              for i in range(n_images)]
    im_info = torch.tensor([600.0, 1000.0, 1.667], device=dev)
    calibrate_heads(model, predict, images[0], im_info)
    predict(images[0], im_info)                          # warm-up
    torch.cuda.synchronize()

    def run(c4_from=None):
        """The requests; returns (dets, ms, c4 features). With ``c4_from``
        each request continues from that request's given c4 feature."""
        dets, times, feats = [], [], []
        for i, img in enumerate(images):
            def swap(_m, _inp, out):
                feats.append(out)
                return None if c4_from is None else c4_from[i]
            hook = model.c4.register_forward_hook(swap)
            try:
                t1 = time.perf_counter()
                o = predict(img, im_info)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
            finally:
                hook.remove()
            dets.append(o["dets"].cpu().numpy())
        return dets, times, feats
    zero_counters()
    dets, times, c4s = run()
    launches = read_launches()
    n_dets = [int((d[:, 0] >= 0).sum()) for d in dets]
    log(f"[e2e fuse_res4] kernel path: ms/image "
        f"{', '.join(f'{x:.3f}' for x in times)}; detections {n_dets}; "
        f"launches {launches}; on {card}")
    for d in dets:
        if not np.isfinite(d).all() or d.shape != (int(cfg.TEST.max_per_image), 6):
            fail(f"fuse_res4: bad detections: shape {d.shape}")
    if min(n_dets) == 0:
        fail("fuse_res4: a request returned no detections")
    must = ["fused_bottleneck_stack", "geom_bias", "nms_keep_sorted"] + (
        [] if tiny else ["stem_conv1_bn_relu"])
    zero = [k for k in must if launches[k] <= 0]
    if zero or launches["fused_bottleneck_stack"] != n_images:
        fail(f"fuse_res4: kernels not launched as expected: {zero}, "
             f"stack {launches['fused_bottleneck_stack']} for {n_images} requests")
    with plain_kernels():
        zero_counters()
        plain_dets, plain_times, plain_c4s = run(c4s)
        own_dets, _, _ = run()
        stray = {k: read_counter(k) for k in COUNTERS if read_counter(k)}
    if stray:
        fail(f"fuse_res4: plain run launched kernels: {stray}")
    errs, bands, own = [], [], []
    for i in range(n_images):
        errs += [f"image {i}: {e}" for e in match_dets(plain_dets[i], dets[i])]
        own.append(len(match_dets(own_dets[i], dets[i])))
        bands.append(_band(torch, c4s[i], plain_c4s[i])[1:])
    # the fused trunk against the conv trunk: the fold scales the weights
    # before the bf16 cast, the conv path after the conv
    with torch.inference_mode():
        conv = model.c4(images[0][None])
    _, rel, corr = _band(torch, c4s[0], conv)
    c4_ok = all(r <= 3e-2 and c > 0.9999 for r, c in bands)
    log(f"[e2e fuse_res4] plain path: ms/image "
        f"{', '.join(f'{x:.3f}' for x in plain_times)}; c4 kernel vs plain "
        f"{', '.join(f'{r:.2e} of max, corr {c:.7f}' for r, c in bands)} (tol "
        f"3e-2, 0.9999); from the kernel path's c4, kernel vs plain "
        f"top-{TOP_K} (IoU>={IOU_MIN}, |ds|<={SCORE_ATOL}): "
        f"{'OK' if not errs else f'{len(errs)} mismatches'}; from its own c4 "
        f"(not held): {own} of {TOP_K} unmatched; fused c4 vs conv c4: corr "
        f"{corr:.6f} (tol 0.999), max diff {rel:.2e} of max")
    if errs:
        for e in errs[:20]:
            log(f"  {e}")
        fail("fuse_res4: kernel path outside the bands of the plain path")
    if not (c4_ok and corr >= 0.999):
        fail("fuse_res4: the fused c4 feature strays from the plain or the conv trunk")
    return launches, statistics.median(times), model


def run_fused_trunk(torch, dev, model, card: str = "", tiny: bool = False):
    """ResNet101C4 with trunk_folded on the flagship's 608x1024 image (every
    res2..res4 block a kernel), against the plain versions and the conv
    trunk; CUDA-event times of the conv trunk, FUSE_RES4 and trunk_folded.
    Returns the launch counts of the trunk_folded call."""
    from relation_tpu_torch.core.predictor import prepare_res4_folded
    from relation_tpu_torch.entry import BUCKET
    from relation_tpu_torch.models.backbone import fold_trunk_params
    H, W = (64, 128) if tiny else BUCKET
    x = torch.tensor(np.random.RandomState(23).randn(1, 12, H // 2, W // 2) * 40.0,
                     dtype=torch.float32, device=dev)
    c4 = model.c4
    trunk = fold_trunk_params(c4)
    res4 = prepare_res4_folded(model, True)
    with torch.inference_mode():
        zero_counters()
        got = c4(x, None, trunk)
        torch.cuda.synchronize()
        launches = read_launches()
        with plain_kernels():
            zero_counters()
            plain = c4(x, None, trunk)
            stray = {k: read_counter(k) for k in COUNTERS if read_counter(k)}
        conv = c4(x)
    if stray:
        fail(f"trunk_folded: plain run launched kernels: {stray}")
    want = {"fused_bottleneck_stack": 3, "fused_proj_bottleneck": 3,
            "stem_conv1_bn_relu": 1}
    if any(launches[k] != n for k, n in want.items()):
        fail(f"trunk_folded: launches {launches}, expected {want}")
    _, rel, corr = _band(torch, got, plain)
    _, conv_rel, conv_corr = _band(torch, got, conv)
    ok = (rel <= 3e-2 and corr > 0.9999 and conv_corr >= 0.999
          and bool(torch.isfinite(got.float()).all()))
    # one call between the events: the conv trunk's ~330 launches take the
    # host longer to queue than the card takes to run them, so a longer
    # window would time the host
    with torch.inference_mode():
        conv_ms = time_ms(torch, lambda: c4(x), inner=1, reps=11)
        res4_ms = time_ms(torch, lambda: c4(x, res4), inner=1, reps=11)
        trunk_ms = time_ms(torch, lambda: c4(x, None, trunk), inner=1, reps=11)
    log(f"[trunk] trunk_folded c4 {tuple(got.shape)}: vs plain versions "
        f"{rel:.2e} of max (tol 3e-2), corr {corr:.7f} (tol 0.9999); vs conv "
        f"trunk {conv_rel:.2e} of max, corr {conv_corr:.6f} (tol 0.999) "
        f"{'OK' if ok else 'FAIL'}; launches {launches}")
    log(f"[trunk] c4 trunk ms (CUDA events, stem included) at {H}x{W}: conv "
        f"{conv_ms:.4f}, FUSE_RES4 {res4_ms:.4f}, trunk_folded {trunk_ms:.4f}; "
        f"on {card}")
    if not ok:
        fail("trunk_folded: the all-kernel trunk disagrees")
    return launches


# --------------------------------------------------------------------------
# phase 10: the FPN families
# --------------------------------------------------------------------------

def serve(torch, reqs, im_info):
    """Run (label, predict, image) requests in order. Returns (dets, host ms,
    the kernel launches of each request)."""
    dets, times, counts = [], [], []
    for _, fn, img in reqs:
        before = {k: read_counter(k) for k in COUNTERS}
        t1 = time.perf_counter()
        o = fn(img, im_info)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        dets.append(o["dets"].cpu().numpy())
        counts.append({k: read_counter(k) - v for k, v in before.items()})
    return dets, times, counts


def run_fpn(torch, dev, card: str = "", tiny: bool = False):
    """The three FPN families served through entry() at full width
    (init_params weights, prediction layers calibrated by
    ``calibrate_heads``): fpn_learn_nms in its default split form (a request
    at the default class threshold, one with 16 active classes, the fused
    skip attention at N=150, and one with 56, the geometric-bias kernel and
    the dense attention), the same model's single-module form
    (TPU.FPN_SPLIT_PREDICT False: 16 active, the skip geometric bias and the
    skip bias attention; 48 active, the geometric bias and the bias attention
    over every class), one fpn_relation request (greedy per-class NMS tail)
    and one fpn request (soft-NMS tail). Each request's learned-NMS kernels
    are counted and held to the branch it must take; the kernel path is held
    to the plain path in the bands of phase 4. ``tiny`` (a rehearsal on the
    CPU) cuts the proposal counts and the image to 64x128; the model stays
    full depth. Returns (launches, {family: ms/image of the default
    request})."""
    from relation_tpu_torch.core.predictor import build_predict_fn
    from relation_tpu_torch.entry import BUCKET, entry, family_cfg
    from relation_tpu_torch.tools.calibrate import calibrate_heads
    H, W = (64, 128) if tiny else BUCKET
    images = [torch.tensor(np.random.RandomState(31 + i).randn(12, H // 2, W // 2)
                           * 40.0, dtype=torch.float32, device=dev)
              for i in range(2)]
    im_info = torch.tensor([600.0, 1000.0, 1.667], device=dev)
    total = {k: 0 for k in COUNTERS}
    ms_image = {}
    # learned-NMS attention launches each request must show (the head's two
    # relation modules add two geom_bias launches to every relation request)
    lnms = ("fused_nms_relation_attention_skip", "fused_geometric_bias_skip",
            "fused_bias_attention_skip", "fused_bias_attention")
    for family in ("fpn_learn_nms", "fpn_relation", "fpn"):
        cfg = family_cfg(family, tiny_shapes=tiny)
        if tiny:
            cfg.TEST.SCORE_THRESH = 0.0
        t0 = time.perf_counter()
        predict, _ = entry(family, device=dev, cfg=cfg)
        model = predict.model
        calibrate_heads(model, predict, images[0], im_info)
        out0 = predict(images[0], im_info)
        torch.cuda.synchronize()
        log(f"[e2e {family}] built and calibrated through entry(): "
            f"{sum(p.numel() for p in model.parameters())} params, "
            f"{time.perf_counter() - t0:.1f} s")
        reqs = [("default threshold", predict, images[0])]
        want = {}
        if family == "fpn_learn_nms":
            single = cfg.copy()
            single.TPU.FPN_SPLIT_PREDICT = False
            reqs = [("split, image 1, default threshold", predict, images[1])]
            for form, c, k, launched in (
                    ("split", cfg, 16, {"fused_nms_relation_attention_skip": 1}),
                    ("split", cfg, 56, {"geom_bias": 3,
                                        "fused_bias_attention": 1}),
                    ("single", single, 16, {"fused_geometric_bias_skip": 1,
                                            "fused_bias_attention_skip": 1}),
                    ("single", single, 48, {"geom_bias": 3,
                                            "fused_bias_attention": 1})):
                label = f"{form}, image 0, {k} active"
                reqs.append((label, with_active(build_predict_fn, model, c, out0, k),
                             images[0]))
                want[label] = {n: launched.get(n, 0) for n in lnms}
                want[label]["geom_bias"] = launched.get("geom_bias", 2)
        for _, fn, img in reqs[1:]:
            fn(img, im_info)                            # warm-up
        torch.cuda.synchronize()

        zero_counters()
        dets, times, counts = serve(torch, reqs, im_info)
        launches = read_launches()
        n_dets = [int((d[:, 0] >= 0).sum()) for d in dets]
        log(f"[e2e {family}] kernel path: " + "; ".join(
            f"{label}: {ms:.3f} ms" for (label, _, _), ms in zip(reqs, times))
            + f"; detections {n_dets}; launches {launches}; on {card}")
        for d in dets:
            if not np.isfinite(d).all() or d.shape != (int(cfg.TEST.max_per_image), 6):
                fail(f"{family}: bad detections: shape {d.shape}")
        if min(n_dets) == 0:
            fail(f"{family}: a request returned no detections")
        wrong = []
        for (label, _, _), got in zip(reqs, counts):
            expected = want.get(label, {})
            if any(got[k] != n for k, n in expected.items()):
                wrong.append(f"{label}: {({k: got[k] for k in expected})} "
                             f"for {expected}")
        if wrong:
            fail(f"{family}: requests off their learned-NMS branch: {wrong}")
        must = ["nms_keep_sorted"] + ([] if tiny else ["stem_conv1_bn_relu"])
        must += [] if family == "fpn" else ["geom_bias"]
        zero = [k for k in must if launches[k] <= 0]
        if zero:
            fail(f"{family}: kernels never launched: {zero}")
        # the proposals' NMS, and the greedy per-class tail's of fpn_relation
        per_request = 2 if family == "fpn_relation" else 1
        if launches["nms_keep_sorted"] < per_request * len(reqs):
            fail(f"{family}: nms_keep_sorted launched "
                 f"{launches['nms_keep_sorted']} times for {len(reqs)} requests")

        with plain_kernels():
            zero_counters()
            plain_dets, plain_times, _ = serve(torch, reqs, im_info)
            stray = {k: read_counter(k) for k in COUNTERS if read_counter(k)}
        if stray:
            fail(f"{family}: plain run launched kernels: {stray}")
        errs = []
        for (label, _, _), ref, new in zip(reqs, plain_dets, dets):
            errs += [f"{label}: {e}" for e in match_dets(ref, new)]
        log(f"[e2e {family}] plain path: " + "; ".join(
            f"{ms:.3f}" for ms in plain_times) + f" ms; kernel vs plain "
            f"top-{TOP_K} (IoU>={IOU_MIN}, |ds|<={SCORE_ATOL}): "
            f"{'OK' if not errs else f'{len(errs)} mismatches'}")
        if errs:
            for e in errs[:20]:
                log(f"  {e}")
            fail(f"{family}: kernel path outside the bands of the plain path")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        ms_image[family] = times[0]
        del model, predict, reqs
        torch.cuda.empty_cache()
    return total, ms_image


# --------------------------------------------------------------------------
# phases 5 and 7: the train step
# --------------------------------------------------------------------------

def training_batch(H, W, B=2, n_gt=3, max_gt=16):
    """Seeded s2d images [B, 12, H/2, W/2] with n_gt ground-truth boxes each
    (padded to max_gt rows), inside an image of 600/608 x 1000/1024 of the
    bucket."""
    rng = np.random.RandomState(11)
    im_h, im_w = H * 600 // 608, W * 1000 // 1024
    gt = np.zeros((B, max_gt, 5), np.float32)
    gv = np.zeros((B, max_gt), bool)
    for b in range(B):
        wh = rng.uniform([W * 0.08, H * 0.1], [W * 0.4, H * 0.5], (n_gt, 2))
        xy = rng.uniform([0, 0], [im_w - 1, im_h - 1] - wh, (n_gt, 2))
        gt[b, :n_gt, :4] = np.concatenate([xy, xy + wh], 1)
        gt[b, :n_gt, 4] = rng.randint(1, 81, n_gt)
        gv[b, :n_gt] = True
    return {"image": (rng.randn(B, 12, H // 2, W // 2) * 40).astype(np.float32),
            "im_info": np.tile([[im_h, im_w, 1.0]], (B, 1)).astype(np.float32),
            "gt_boxes": gt, "gt_valid": gv}


def run_training(torch, dev, card: str = "", tiny: bool = False,
                 family: str = "flagship", dense_steps: int = 3,
                 fused_steps: int = 2, roi_method: str = "align"):
    """Train steps of one family on the kernels (``dense_steps`` with the
    dense learned-NMS attention, then ``fused_steps`` with the fully fused
    one), then one unclipped step from the same start on the kernels and on
    the plain versions. A DCN family gets its offset branches seeded away
    from zero, and its unclipped pair of steps computes in f32 (see below);
    an FPN family gets its prediction layers calibrated as in phase 10.
    ``tiny`` (a rehearsal on the CPU) takes the tiny trunk and a 64x128
    image. ``roi_method`` is TPU.ROI_METHOD ("pool": the ROIPooling kernel,
    forward and backward, once an image a step). Returns (the launch counts
    of the clipped steps, the median ms/step after one warm-up, the peak
    memory in GiB)."""
    from relation_tpu_torch.ops.kernels import roi_pool as RP
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.predictor import build_predict_fn
    from relation_tpu_torch.core.trainer import (build_model, create_train_state,
                                                 make_train_step, trainable_mask)
    from relation_tpu_torch.entry import BUCKET, family_cfg
    from relation_tpu_torch.tools.calibrate import calibrate_heads, seed_offsets
    H, W = (64, 128) if tiny else BUCKET
    batch = training_batch(H, W)
    B = batch["image"].shape[0]
    dcn, fpn = family.startswith("dcn"), family.startswith("fpn")
    pool = roi_method == "pool"
    tag = f"[train {family}{' roi_method=pool' if pool else ''}]"
    steps = dense_steps + fused_steps

    def fresh(clip, weights=None, f32=False):
        cfg = family_cfg(family, tiny_shapes=tiny)
        cfg.TPU.GRAD_CLIP = clip
        cfg.TPU.ROI_METHOD = roi_method
        if f32:
            cfg.TPU.COMPUTE_DTYPE = cfg.TPU.HEAD_DTYPE = "float32"
            cfg.TPU.DCN_POOL_DTYPE = "float32"
        model = build_model(cfg, tiny=tiny, device=dev)
        if weights is not None:
            model.load_state_dict(weights)
        else:
            init_params(model, seed=0)
            if dcn:
                seed_offsets(model, cfg, batch["image"][0],
                             batch["im_info"][0])
            if fpn:
                calibrate_heads(model, build_predict_fn(model, cfg),
                                torch.tensor(batch["image"][0], device=dev),
                                torch.tensor(batch["im_info"][0], device=dev))
        return (model, create_train_state(model, cfg, seed=0),
                make_train_step(model, cfg, device=dev))

    def one_step(step, state):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return {k: float(v) for k, v in m.items()}, ms

    # init_params leaves every BatchNorm at identity, so the random trunk's
    # activations reach several hundred and an unclipped second step
    # diverges: the five steps run with the trainer's global-norm clip
    # (TPU.GRAD_CLIP) at 10; the one-step comparison below runs without it
    model, state, step = fresh(10.0)
    start = _snapshot(model)
    mask = trainable_mask(model, tuple(family_cfg(family).network.FIXED_PARAMS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    RP.bwd_launches = 0
    history, times = [], []
    for i in range(steps):
        # the first steps on the dense learned-NMS attention, the rest on
        # the fused one
        if fused_steps:
            model.learn_nms_head.NMSRelationModule_0.fully_fused = i >= dense_steps
        m, ms = one_step(step, state)
        history.append(m)
        times.append(ms)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [m["total_loss"] for m in history]
    for i, m in enumerate(history):
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        if bad:
            fail(f"train step {i}: non-finite {bad}; total_loss per step {losses}")
    if losses[-1] == losses[0]:
        fail("total_loss did not move over the train steps")
    end = model.state_dict()
    still = [n for n, on in mask.items() if on and torch.equal(end[n], start[n])]
    # an FPN leaf at zero whose momentum trace is still exactly zero got no
    # gradient in any step (weight decay moves a non-zero leaf): the
    # smoothing conv's bias of a level none of whose anchors or ROIs the
    # steps sampled (P6 at 608x1024, the coarse levels of the rehearsal's
    # image). It is excused only if the plain versions' step from the same
    # start gives it no gradient either (checked below); a C4 or DCN family
    # excuses nothing
    idle = [n for n in still
            if fpn and not start[n].any() and not state.trace[n].any()]
    still = [n for n in still if n not in idle]
    strayed = [n for n, on in mask.items()
               if not on and not torch.equal(end[n], start[n])]
    if still or strayed:
        fail(f"trainable leaves that did not move: {still[:5]} ({len(still)}); "
             f"frozen leaves that moved: {strayed[:5]} ({len(strayed)})")
    # the geometric bias of the two relation modules an image, and of the
    # learned-NMS attention an image of a dense step (a fused step fuses it);
    # the bias attention once an image of a dense learned-NMS step; the tiny
    # trunk has neither the conv1 stem nor a deformable res5 (three
    # deformable convs a step)
    rel = 2 if model.use_relation else 0
    lnms = 1 if model.use_learn_nms else 0
    geom = dense_steps * B * (rel + lnms) + fused_steps * B * rel
    want = {"geom_bias_bwd": geom,
            "fused_nms_relation_attention": fused_steps * B,
            "fused_bias_attention": dense_steps * B * lnms,
            "stem_conv1_bn_relu": 0 if tiny else steps,
            "nms_keep_sorted": steps * B,
            "geom_bias": geom,
            "dconv_col2im": 3 * steps if dcn and not tiny else 0,
            "roi_pool": steps * B if pool and not fpn else 0}
    short = {k: (launches[k], n) for k, n in want.items() if launches[k] < n}
    if pool and RP.bwd_launches < launches["roi_pool"]:
        short["roi_pool backward"] = (RP.bwd_launches, launches["roi_pool"])
    if launches["dconv_col2im"] != want["dconv_col2im"]:
        short["dconv_col2im"] = (launches["dconv_col2im"], want["dconv_col2im"])
    if short:
        fail(f"kernels launched too rarely in training (got, expected): {short}")
    fused_ms = f"{times[-1]:.3f}" if fused_steps else "n/a"
    dense_ms = statistics.median(times[1:dense_steps])
    log(f"{tag} kernel path, B={B}: total_loss per step "
        f"{', '.join(f'{x:.6f}' for x in losses)}; ms/step "
        f"{', '.join(f'{x:.3f}' for x in times)}; median after one warm-up: dense "
        f"{dense_ms:.3f} ms/step, fully fused "
        f"{fused_ms} ms/step; peak memory {peak_gb:.3f} GiB; "
        f"{sum(mask.values()) - len(idle)} trainable leaves moved, {len(idle)} "
        f"at zero with no gradient {idle}, "
        f"{len(mask) - sum(mask.values())} frozen leaves still; launches "
        f"{launches}; on {card}")

    # A DCN step in bf16 is not reproducible to 1e-3 in its update norm, not
    # even the plain path against itself: a difference in the last bit grows
    # through the bf16 backward to 2e-3 to 4e-3 of each leaf's update, and
    # most of the norm is the three res5 offset convs' update, whose noise
    # moves the norm by up to 1e-3 (flagship: 2e-5; PERF.md section 6). In
    # f32 the DCN kernel and plain steps agree to 1e-4, so its comparison
    # computes in f32: col2im then takes f32 rows and the stem is the plain
    # conv (the kernel checks hold both to their plain versions, and the
    # flagship's comparison runs the stem kernel in bf16).
    f32 = dcn and not tiny
    del model, state, step, end
    model, state, step = fresh(0.0, start, f32)
    zero_counters()
    first_m, _ = one_step(step, state)
    first_launches = read_launches()
    first_norm = _update_norm(model, start)
    del model, state, step
    # a dense step, so every kernel of the clipped dense steps but the stem
    # in f32
    missing = [k for k in ("geom_bias", "geom_bias_bwd", "fused_bias_attention",
                           "nms_keep_sorted", "stem_conv1_bn_relu", "dconv_col2im",
                           "roi_pool")
               if want[k] and not first_launches[k]
               and not (f32 and k == "stem_conv1_bn_relu")]
    if missing:
        fail(f"the unclipped kernel step launched none of {missing}")
    with plain_kernels():
        model, state, step = fresh(0.0, start, f32)
        zero_counters()
        plain_m, plain_ms = one_step(step, state)
        stray = {k: read_counter(k) for k in COUNTERS if read_counter(k)}
        plain_norm = _update_norm(model, start)
        fed = [n for n in idle if state.trace[n].any()]
    if stray:
        fail(f"plain train step launched kernels: {stray}")
    if fed:
        fail(f"leaves that got no gradient on the kernels but one on the plain "
             f"versions: {fed}")
    worst = max((abs(first_m[k] - v) / max(abs(v), 1e-6), k)
                for k, v in plain_m.items() if k.endswith("loss"))
    norm_err = abs(first_norm - plain_norm) / plain_norm
    ok = worst[0] <= 1e-3 and norm_err <= 1e-3
    log(f"{tag} one unclipped step{' in f32' if f32 else ''}, plain path: total_loss "
        f"{plain_m['total_loss']:.6f} ({plain_ms:.3f} ms, first call), no gradient "
        f"either for the {len(idle)} leaves at zero; kernel "
        f"path: total_loss {first_m['total_loss']:.6f}; kernel vs plain: worst loss "
        f"{worst[1]} rel {worst[0]:.2e}, update norm {first_norm:.6e} vs "
        f"{plain_norm:.6e} rel {norm_err:.2e} (tol 1e-3) {'OK' if ok else 'FAIL'}")
    if not ok:
        fail(f"{family}: the kernel train step disagrees with the plain train "
             "step")
    return launches, dense_ms, peak_gb


# --------------------------------------------------------------------------
# phase 12: the alternate (cached-proposal) workflow
# --------------------------------------------------------------------------

def match_proposals(ref, new, top: int = 300):
    """Each of the ``top`` best proposals of ``ref`` ([N, 5], descending
    score) matched by one of ``new`` at IoU >= 0.95 with |score delta| <=
    2e-2 (after NMS at 0.7 a match is unique). Returns a list of errors."""
    errs = []
    if not len(new):
        return ["no proposals"] if len(ref) else []
    for i, g in enumerate(ref[:top]):
        ious = iou(g[:4], new[:, :4])
        j = int(np.argmax(ious))
        if ious[j] < IOU_MIN:
            errs.append(f"proposal {i}: best IoU {ious[j]:.3f}")
        elif abs(new[j, 4] - g[4]) > SCORE_ATOL:
            errs.append(f"proposal {i}: score {new[j, 4]:.4f} vs {g[4]:.4f}")
    return errs


def launches_since(before: dict) -> dict:
    """The launch counts (and by shape) added since ``before``
    (``read_launches()``), those that moved only."""
    return {k: v - before.get(k, 0) for k, v in read_launches().items()
            if v != before.get(k, 0)}


def _snapshot(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _update_norm(model, before) -> float:
    return sum(float(((p.detach().double() - before[k].double()) ** 2).sum())
               for k, p in model.named_parameters()) ** 0.5


def workflow_setup(torch, dev, tiny: bool = False):
    """The set-up of phase 12: fpn_learn_nms's config (entry.py::family_cfg,
    TPU.GRAD_CLIP 10), the three seeded images of ``training_batch`` (the
    batch, its ``(id, image, im_info)`` items and its ground-truth roidb)
    and the model, init_params(seed=0) weights with calibrated prediction
    layers. ``tiny``: the tiny trunk on 64x128 images and cut proposal
    counts. Returns ``(cfg, data, items, roidb, model)``."""
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.predictor import build_predict_fn
    from relation_tpu_torch.core.trainer import build_model
    from relation_tpu_torch.entry import BUCKET, family_cfg
    from relation_tpu_torch.tools.calibrate import calibrate_heads
    H, W = (64, 128) if tiny else BUCKET
    data = training_batch(H, W, B=3)
    cfg = family_cfg("fpn_learn_nms", tiny_shapes=tiny)
    cfg.TPU.GRAD_CLIP = 10.0
    items = [(i, data["image"][i], data["im_info"][i]) for i in range(3)]
    roidb = []
    for i in range(3):
        gt = data["gt_boxes"][i][data["gt_valid"][i]]
        roidb.append({"image": f"seeded_{i}", "boxes": gt[:, :4],
                      "gt_classes": gt[:, 4].astype(np.int32),
                      "iscrowd": np.zeros(len(gt), bool)})
    model = init_params(build_model(cfg, tiny=tiny, device=dev), seed=0)
    calibrate_heads(model, build_predict_fn(model, cfg),
                    torch.tensor(items[0][1], device=dev),
                    torch.tensor(items[0][2], device=dev))
    torch.cuda.synchronize()
    return cfg, data, items, roidb, model


def workflow_batch(data, i: int, **extra) -> dict:
    """Image ``i`` of ``data`` as a one-image batch, with ``extra`` arrays
    (the cached ROIs) given their batch axis."""
    b = {k: data[k][i:i + 1] for k in ("image", "im_info", "gt_boxes",
                                        "gt_valid")}
    b.update({k: v[None] for k, v in extra.items()})
    return b


def cached_rois(prop_roidb, data, i: int, R: int):
    """Image ``i``'s cached proposals (``load_proposal_roidb``, original-image
    coordinates) scaled to the network input by im_info[2] and padded to
    ``R`` rows: ``(rois [R, 4], rois_valid [R])``."""
    p = prop_roidb[i]["proposals"] * float(data["im_info"][i][2])
    rois = np.zeros((R, 4), np.float32)
    rois[:len(p)] = p[:R]
    return rois, np.arange(R) < len(p)


def run_workflow(torch, dev, card: str = "", tiny: bool = False):
    """Phase 12: fpn_learn_nms through the alternate workflow at full width
    (entry.py::family_cfg with the YAML's TEST.PROPOSAL_* 20000 -> 2000,
    TOP_ROIS 1000, FIXED_PARAMS_SHARED, one image a batch), init_params
    weights with calibrated prediction layers, the three seeded images of
    ``training_batch`` (three boxes each), steps under TPU.GRAD_CLIP 10:
    (a) two RPN-only steps; (b) the proposal dump over the three images into
    a pickle, kernel path against plain path; (c) recall, the proposal
    roidb and the bbox-target statistics on the host; (d) three RCNN steps
    on the cached proposals with train_shared (FIXED_PARAMS_SHARED leaves
    bit-equal, every other trainable leaf moves), then one unclipped step
    from the stage's start on the kernels against the plain versions within
    1e-3; (e) the checkpoint written and restored into a freshly built
    model, bit-equal; (f) predict_rcnn from the restored model on image 0's
    cached proposals at score threshold 0, held to the plain path and to the
    trained model's detections in the bands of phase 4, its merged scores to
    the plain path's within 1e-3 of their largest. ``tiny`` (a rehearsal on the CPU)
    takes the tiny trunk, a 64x128 image and cut proposal counts. Returns
    the launches of the kernel path."""
    import pickle
    import tempfile

    from relation_tpu_torch.core.checkpoint import (load_params,
                                                    restore_checkpoint,
                                                    save_checkpoint, save_params)
    from relation_tpu_torch.core.predictor import make_predict_fn_rcnn
    from relation_tpu_torch.core.rpn_workflow import (add_bbox_regression_stats,
                                                      evaluate_recall,
                                                      generate_rpn_proposals,
                                                      load_proposal_roidb,
                                                      make_train_step_rcnn,
                                                      make_train_step_rpn)
    from relation_tpu_torch.core.trainer import (build_model, create_train_state,
                                                 refreeze_state, trainable_mask)
    tag = "[workflow fpn_learn_nms]"

    def timed(fn, *a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    cfg, data, items, roidb, model = workflow_setup(torch, dev, tiny)
    if tiny:
        cfg.TEST.SCORE_THRESH = 0.0
    max_gt = data["gt_boxes"].shape[1]
    shared = tuple(cfg.network.FIXED_PARAMS_SHARED)
    R = int(cfg.TRAIN.TOP_ROIS)
    log(f"{tag} built and calibrated: {sum(p.numel() for p in model.parameters())} "
        f"params, {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_workflow_")

    # (a) the RPN alone
    state = create_train_state(model, cfg, seed=0)
    rpn_step = make_train_step_rpn(model, cfg, max_gt=max_gt, device=dev)
    rpn_hist, rpn_ms = [], []
    for _ in range(2):
        (state, m), ms = timed(rpn_step, state, workflow_batch(data, 0))
        rpn_hist.append({k: float(v) for k, v in m.items()})
        rpn_ms.append(ms)
    bad = [k for m in rpn_hist for k, v in m.items() if not np.isfinite(v)]
    if bad or rpn_hist[1]["total_loss"] == rpn_hist[0]["total_loss"]:
        fail(f"{tag} RPN steps: non-finite {bad} or a loss that did not move "
             f"({[m['total_loss'] for m in rpn_hist]})")
    log(f"{tag} (a) RPN steps: total_loss {rpn_hist[0]['total_loss']:.6f} -> "
        f"{rpn_hist[1]['total_loss']:.6f}; ms/step {rpn_ms[0]:.3f} (first), "
        f"{rpn_ms[1]:.3f} on {card}")

    # (b) the proposal dump, kernel path then plain path
    pkl = os.path.join(tmp.name, "train_rpn.pkl")
    before = read_launches()
    generate_rpn_proposals(model, cfg, roidb[:1], pkl, loader=items[:1],
                           device=dev)                       # warm-up
    _, dump_ms = timed(generate_rpn_proposals, model, cfg, roidb, pkl,
                       loader=items, device=dev)
    nms_shapes = {k.split("@", 1)[1]: v for k, v in launches_since(before).items()
                  if k.startswith("nms_keep_sorted@")}
    with open(pkl, "rb") as f:
        props = pickle.load(f)
    plain_pkl = os.path.join(tmp.name, "plain_rpn.pkl")
    with plain_kernels():
        before = read_launches()
        generate_rpn_proposals(model, cfg, roidb, plain_pkl, loader=items,
                               device=dev)
        stray = launches_since(before)
    if stray:
        fail(f"{tag} the plain proposal dump launched kernels: {stray}")
    with open(plain_pkl, "rb") as f:
        plain_props = pickle.load(f)
    errs = [f"image {i}: {e}" for i, (p, q) in enumerate(zip(plain_props, props))
            for e in match_proposals(p, q)]
    # 20000 boxes of the 155,520 anchors, padded to 256-box chunks
    want_shape = "C=1 Np=128" if tiny else "C=1 Np=20224"
    log(f"{tag} (b) proposal dump: {[len(p) for p in props]} proposals an image "
        f"(plain path {[len(p) for p in plain_props]}); "
        f"{dump_ms / len(items):.3f} ms/image on {card}; NMS launches by shape "
        f"{nms_shapes}; kernel vs plain top-300 (IoU>={IOU_MIN}, "
        f"|ds|<={SCORE_ATOL}): {'OK' if not errs else f'{len(errs)} mismatches'}")
    if errs:
        for e in errs[:20]:
            log(f"  {e}")
        fail(f"{tag} kernel-path proposals outside the bands of the plain path")
    if nms_shapes != {want_shape: len(items) + 1}:
        fail(f"{tag} the proposal dump's NMS launches {nms_shapes}, not "
             f"{len(items) + 1} at {want_shape}")
    if any(not np.isfinite(p).all() or p.shape[1] != 5 or len(p) == 0
           for p in props):
        fail(f"{tag} the proposal pickle holds empty or non-finite arrays")

    # (c) recall, the proposal roidb and the bbox-target statistics
    rec = evaluate_recall(roidb, props)
    prop_roidb = load_proposal_roidb(roidb, pkl, top_rois=R)
    means, stds = add_bbox_regression_stats(
        prop_roidb, int(cfg.dataset.NUM_CLASSES), bool(cfg.CLASS_AGNOSTIC),
        float(cfg.TRAIN.BBOX_REGRESSION_THRESH))
    if not (np.isfinite(rec["ar"]) and np.isfinite(means).all()
            and np.isfinite(stds).all()):
        fail(f"{tag} non-finite recall or bbox-target statistics")
    log(f"{tag} (c) recall over {rec['num_gt']} boxes: AR {rec['ar']:.4f}, "
        f"recall at IoU 0.5 {rec['recalls'][0]:.4f}, 0.7 {rec['recalls'][4]:.4f}; "
        f"{[len(e['proposals']) for e in prop_roidb]} cached ROIs an image "
        f"(TOP_ROIS {R}); target means {np.round(means[1], 4).tolist()} stds "
        f"{np.round(stds[1], 4).tolist()}")

    def rois_of(i):
        return cached_rois(prop_roidb, data, i, R)

    def rcnn_batch(i):
        rois, valid = rois_of(i)
        return workflow_batch(data, i, rois=rois, rois_valid=valid)

    # (d) the RCNN head on the cached proposals, the trunk shared
    state = refreeze_state(state, cfg, shared)
    start = _snapshot(model)
    mask = trainable_mask(model, shared)
    rcnn_step = make_train_step_rcnn(model, cfg, max_rois=R, max_gt=max_gt,
                                     train_shared=True, device=dev)
    before = read_launches()
    hist, times = [], []
    for i in range(3):
        (state, m), ms = timed(rcnn_step, state, rcnn_batch(i))
        hist.append({k: float(v) for k, v in m.items()})
        times.append(ms)
    step_launches = launches_since(before)
    losses = [m["total_loss"] for m in hist]
    bad = [k for m in hist for k, v in m.items() if not np.isfinite(v)]
    if bad:
        fail(f"{tag} RCNN steps: non-finite {bad}; total_loss {losses}")
    end = model.state_dict()
    strayed = [k for k, on in mask.items() if not on and not torch.equal(end[k], start[k])]
    still = [k for k, on in mask.items() if on and torch.equal(end[k], start[k])]
    # phase 11's excuse: an FPN leaf at zero whose trace is still zero got no
    # gradient (checked against the plain step below)
    idle = [k for k in still if not start[k].any() and not state.trace[k].any()]
    still = [k for k in still if k not in idle]
    if strayed or still:
        fail(f"{tag} FIXED_PARAMS_SHARED leaves that moved: {strayed[:5]} "
             f"({len(strayed)}); trainable leaves that did not: {still[:5]} "
             f"({len(still)})")
    short = [k for k in ("geom_bias", "geom_bias_bwd", "fused_bias_attention")
             if step_launches.get(k, 0) <= 0]
    if short:
        fail(f"{tag} the RCNN steps never launched {short}")
    rcnn_ms = statistics.median(times[1:])
    log(f"{tag} (d) RCNN steps, train_shared: total_loss "
        f"{', '.join(f'{x:.6f}' for x in losses)}; ms/step "
        f"{', '.join(f'{x:.3f}' for x in times)}, median after one warm-up "
        f"{rcnn_ms:.3f}; {sum(mask.values()) - len(idle)} trainable leaves moved, "
        f"{len(idle)} at zero with no gradient {idle}, "
        f"{len(mask) - sum(mask.values())} FIXED_PARAMS_SHARED leaves bit-equal; "
        f"launches {step_launches}; on {card}")

    def fresh_rcnn():
        c = cfg.copy()
        c.TPU.GRAD_CLIP = 0.0
        m = build_model(c, tiny=tiny, device=dev)
        m.load_state_dict(start)
        st = refreeze_state(create_train_state(m, c, seed=0), c, shared)
        return m, st, make_train_step_rcnn(m, c, max_rois=R, max_gt=max_gt,
                                           train_shared=True, device=dev)
    m3, st3, step3 = fresh_rcnn()
    _, k_m = step3(st3, rcnn_batch(0))
    k_m = {k: float(v) for k, v in k_m.items()}
    k_norm = _update_norm(m3, start)
    del m3, st3, step3
    with plain_kernels():
        before = read_launches()
        m4, st4, step4 = fresh_rcnn()
        _, p_m = step4(st4, rcnn_batch(0))
        p_m = {k: float(v) for k, v in p_m.items()}
        p_norm = _update_norm(m4, start)
        fed = [k for k in idle if st4.trace[k].any()]
        stray = launches_since(before)
        del m4, st4, step4
    if stray or fed:
        fail(f"{tag} plain RCNN step launched kernels {stray}, or gave a "
             f"gradient to the excused leaves {fed}")
    worst = max((abs(k_m[k] - v) / max(abs(v), 1e-6), k)
                for k, v in p_m.items() if k.endswith("loss"))
    norm_err = abs(k_norm - p_norm) / p_norm
    ok = worst[0] <= 1e-3 and norm_err <= 1e-3
    log(f"{tag} (d) one unclipped RCNN step, kernel vs plain: total_loss "
        f"{k_m['total_loss']:.6f} vs {p_m['total_loss']:.6f}, worst loss "
        f"{worst[1]} rel {worst[0]:.2e}, update norm {k_norm:.6e} vs "
        f"{p_norm:.6e} rel {norm_err:.2e} (tol 1e-3) {'OK' if ok else 'FAIL'}")
    if not ok:
        fail(f"{tag} the kernel RCNN step disagrees with the plain RCNN step")

    # (e) the checkpoint round trip, into a freshly built model
    ckpt, save_ms = timed(save_checkpoint, os.path.join(tmp.name, "rcnn.ckpt"),
                          state)
    pfile = save_params(os.path.join(tmp.name, "rcnn.params"), model)
    model2 = build_model(cfg, tiny=tiny, device=dev)
    state2 = refreeze_state(create_train_state(model2, cfg, seed=1), cfg, shared)
    _, load_ms = timed(restore_checkpoint, ckpt, state2)
    a, b = model.state_dict(), model2.state_dict()
    loaded = load_params(pfile, model2)
    diff = [k for k in a if not torch.equal(a[k], b[k])
            or not torch.equal(a[k].cpu(), loaded[k])]
    tdiff = [k for k in state.trace if not torch.equal(state.trace[k],
                                                       state2.trace[k])]
    same = (not diff and not tdiff and set(state.trace) == set(state2.trace)
            and (state2.step, state2.count) == (state.step, state.count)
            and torch.equal(state.generator.get_state(),
                            state2.generator.get_state()))
    log(f"{tag} (e) checkpoint {os.path.getsize(ckpt) / 2 ** 20:.1f} MiB "
        f"(save {save_ms:.0f} ms, restore {load_ms:.0f} ms): {len(a)} parameters "
        f"and {len(state.trace)} traces bit-equal, step {state2.step}, count "
        f"{state2.count}, generator: {'OK' if same else 'FAIL'}")
    if not same:
        fail(f"{tag} the restored state differs: params {diff[:5]}, traces "
             f"{tdiff[:5]}")

    # (f) predict_rcnn from the restored model on image 0's cached proposals.
    # Three steps on three boxes leave every merged class score below
    # TEST.SCORE_THRESH (1e-3): no detection at all on the card. At 0 the top
    # 100 of the 150 x 80 merged scores are detections, and the merged
    # scores themselves are held to the plain path's
    pcfg = cfg.copy()
    pcfg.TEST.SCORE_THRESH = 0.0
    rois, valid = rois_of(0)
    img, info = items[0][1], items[0][2]
    pred = make_predict_fn_rcnn(model2, pcfg)
    pred(img, info, rois, valid)                              # warm-up
    pred_times, out = [], None
    for _ in range(3):
        out, ms = timed(pred, img, info, rois, valid)
        pred_times.append(ms)
    dets = out["dets"].cpu().numpy()
    scores = out["final_score"].float().cpu().numpy()
    trained = make_predict_fn_rcnn(model, pcfg)(img, info, rois, valid)
    trained = trained["dets"].cpu().numpy()
    counts = read_launches()
    with plain_kernels():
        before = read_launches()
        plain = make_predict_fn_rcnn(model2, pcfg)(img, info, rois, valid)
        plain_scores = plain["final_score"].float().cpu().numpy()
        plain = plain["dets"].cpu().numpy()
        stray = launches_since(before)
    top_score = float(np.abs(plain_scores).max())
    score_err = float(np.abs(scores - plain_scores).max()) / max(top_score, 1e-30)
    errs = match_dets(plain, dets) + [f"trained model: {e}" for e in
                                      match_dets(trained, dets)]
    if score_err > 1e-3:
        errs.append(f"merged scores: max difference {score_err:.2e} of the "
                    f"largest, {top_score:.3e}")
    n_dets = int((dets[:, 0] >= 0).sum())
    pred_ms = statistics.median(pred_times)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{tag} (f) predict_rcnn over {int(valid.sum())} cached ROIs: "
        f"{n_dets} detections at score threshold 0, largest merged score "
        f"{top_score:.3e}, kernel vs plain {score_err:.2e} of it (tol 1e-3); "
        f"ms/image {', '.join(f'{x:.3f}' for x in pred_times)}"
        f" (median {pred_ms:.3f}); restored vs plain and vs the trained model "
        f"top-{TOP_K} (IoU>={IOU_MIN}, |ds|<={SCORE_ATOL}): "
        f"{'OK' if not errs else f'{len(errs)} mismatches'}; bit-equal to the "
        f"trained model's: {np.array_equal(dets, trained)}; on {card}")
    if errs or stray:
        for e in errs[:20]:
            log(f"  {e}")
        fail(f"{tag} predict_rcnn outside the bands, or the plain path "
             f"launched kernels {stray}")
    if (not np.isfinite(dets).all() or dets.shape != (int(cfg.TEST.max_per_image), 6)
            or n_dets < int(cfg.TEST.max_per_image)):
        fail(f"{tag} bad detections: shape {dets.shape}, {n_dets} real")
    tmp.cleanup()
    must = ["nms_keep_sorted", "geom_bias", "geom_bias_bwd",
            "fused_bias_attention"] + ([] if tiny else ["stem_conv1_bn_relu"])
    zero = [k for k in must if counts[k] <= 0]
    if zero:
        fail(f"{tag} kernels never launched: {zero}")
    log(f"[e2e] workflow fpn_learn_nms: RPN step {rpn_ms[1]:.3f} ms, proposal "
        f"dump {dump_ms / len(items):.3f} ms/image, RCNN step {rcnn_ms:.3f} "
        f"ms, predict_rcnn {pred_ms:.3f} ms/image, peak memory {peak_gb:.3f} "
        f"GiB; launches {counts}; on {card}")
    del model, model2, state, state2
    return counts


FLAGSHIP_YAML = ("experiments/cfgs/resnet_v1_101_coco_trainvalminus_rcnn_end2end_"
                 "relation_learn_nms_8epoch.yaml")


def eval_yaml(path: str, tiny: bool) -> str:
    """The flagship YAML (symbol, SCALES, dataset sets, TRAIN and TEST as
    the repo ships them) with the trainer's clip of phase 5
    (TPU.GRAD_CLIP 10: init_params weights diverge unclipped), written to
    ``path``. ``tiny`` (a rehearsal on the CPU) adds the tiny images'
    SCALES and buckets and family_cfg's cut proposal counts."""
    with open(os.path.join(HERE, FLAGSHIP_YAML)) as f:
        text = f.read()
    text += "TPU:\n  GRAD_CLIP: 10.0\n"
    if tiny:
        text = text.replace("SCALES:\n- 600\n- 1000\n", "SCALES: [64, 96]\n")
        text += "  IMAGE_BUCKETS: [[64, 96], [96, 64]]\n"
        for key, val in (("RPN_PRE_NMS_TOP_N: 6000", "RPN_PRE_NMS_TOP_N: 128"),
                         ("RPN_POST_NMS_TOP_N: 300", "RPN_POST_NMS_TOP_N: 48"),
                         ("FIRST_N: 100", "FIRST_N: 16")):
            text = text.replace(key, val)
    with open(path, "w") as f:
        f.write(text)
    return path


def run_eval(torch, dev, card: str = "", tiny: bool = False,
             use_pil: bool | None = None):
    """Phase 13: the flagship end to end from a dataset on disk, through the
    drivers a user runs, then the cached-proposal path with a real loader.
    (a) a seeded mini COCO-layout dataset at the YAML's ./data/coco in a
    temporary working directory (tools/mini_coco.py: train2014 and
    valminusminival2014 of three images, minival2014 of six 480x640 and two
    640x480 images, one to four boxes an image with COCO ids, a crowd box a
    set), PNG files read through PIL where PIL imports, else the same
    arrays handed to the loaders (``image_loader``); (b) experiments/train.py
    for four steps through the TrainLoader (flipped entries, uint8 s2d
    batches, init_params weights, TPU.GRAD_CLIP 10 as phase 5); (c)
    experiments/test.py on the newest params file, found as
    rcnn_end2end_train_test finds it, at score threshold 0 (every image
    gives its 100 detections), bit-equal to the trained model's own
    predictions on TestLoader's items; (d) pred_eval of the trained model
    bit-equal to the same direct calls, and the kernel path held to the
    plain path in the bands of phase 4; (e) the ground truth fed back as
    detections gives AP 1.0, and the NumPy matching route the native
    route's results; (f) fpn_learn_nms (calibrated as phase 10, TEST.HAS_RPN
    false): generate_rpn_proposals(loader=None) over the test roidb, then
    pred_eval_rcnn through the ProposalTestLoader. ``tiny`` (a rehearsal on
    the CPU): the tiny trunk on 48x64 and 64x48 images. Returns the
    launches of the driven paths."""
    import tempfile

    from relation_tpu_torch.config.defaults import load_config
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.evaluator import pred_eval, pred_eval_rcnn
    from relation_tpu_torch.core.predictor import build_predict_fn
    from relation_tpu_torch.core.rpn_workflow import generate_rpn_proposals
    from relation_tpu_torch.core.trainer import build_model
    from relation_tpu_torch.data.coco import COCO_CAT_IDS, coco_dataset
    from relation_tpu_torch.data.eval import CocoEvaluator
    from relation_tpu_torch.data.loader import (ProposalTestLoader, TestLoader,
                                                TrainLoader)
    from relation_tpu_torch.entry import family_cfg
    from relation_tpu_torch.experiments import rcnn_end2end_train_test as e2e
    from relation_tpu_torch.experiments import test as test_driver
    from relation_tpu_torch.experiments import train as train_driver
    from relation_tpu_torch.tools.calibrate import calibrate_heads
    from relation_tpu_torch.tools.mini_coco import array_loader, write_mini_coco
    from relation_tpu_torch.utils import native
    tag = "[eval flagship]"
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # (a) the dataset, in a working directory of its own
    if use_pil is None:
        try:
            import PIL  # noqa: F401
            use_pil = True
        except ImportError:
            use_pil = False
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_eval_")
    cwd = os.getcwd()
    os.chdir(tmp.name)
    try:
        land, port = ((48, 64), (64, 48)) if tiny else ((480, 640), (640, 480))
        arrays = write_mini_coco(
            "data/coco", {"train2014": [land, port], "valminusminival2014": [land],
                          "minival2014": [land] * 6 + [port] * 2},
            seed=13, all_cat_ids=COCO_CAT_IDS, png=use_pil)
        image_loader = None if use_pil else array_loader(arrays)
        log(f"{tag} (a) route: "
            + ("PNG files decoded by PIL" if use_pil else
               "PIL missing: the seeded arrays handed to the loaders "
               "(image_loader=)")
            + f"; matching route: {'native' if native.have_native() else 'NumPy'}"
            f" (utils/native.py)")
        yaml = eval_yaml("flagship.yaml", tiny)
        common = ["--cfg", yaml, "--device", dev.type] + (
            ["--tiny"] if tiny else [])
        cfg = load_config(yaml)
        cfg.TEST.SCORE_THRESH = 0.0
        test_set = cfg.dataset.test_image_set
        dataset = coco_dataset(cfg.dataset.dataset_path, test_set)
        roidb = dataset.roidb()

        # (b) the train driver, four steps, its batches recorded on the way
        seen = []
        load_one = TrainLoader._load_one

        def recording(self, entry):
            out = load_one(self, entry)
            seen.append((bool(entry["flipped"]), out[0].dtype, out[0].shape))
            return out
        TrainLoader._load_one = recording
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        try:
            trained = train_driver.main(common + ["--steps", "4"],
                                        image_loader=image_loader)
        finally:
            TrainLoader._load_one = load_one
        counts = read_launches()
        add(counts)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        step_ms = [s * 1e3 for s in trained["step_s"]]
        data_ms = [s * 1e3 for s in trained["data_s"]]
        bad = [k for k, v in trained["metrics"].items() if not np.isfinite(v)]
        kinds = sorted({(str(d), tuple(sh)) for _, d, sh in seen})
        log(f"{tag} (b) train driver: {len(step_ms)} steps, total_loss "
            f"{trained['metrics'].get('total_loss', float('nan')):.6f}; ms/step "
            f"{', '.join(f'{x:.3f}' for x in step_ms)} (median of steps 2-4 "
            f"{statistics.median(step_ms[1:]):.3f}), loader wait ms "
            f"{', '.join(f'{x:.3f}' for x in data_ms)}; peak memory "
            f"{peak_gb:.3f} GiB; checkpoint "
            f"{os.path.getsize(trained['checkpoint']) / 2 ** 20:.1f} MiB, params "
            f"{os.path.getsize(trained['params']) / 2 ** 20:.1f} MiB, both saved "
            f"in {trained['save_s'] * 1e3:.0f} ms; images loaded "
            f"{len(seen)} ({sum(f for f, _, _ in seen)} flipped) as {kinds}; "
            f"launches {counts}; on {card}")
        must = ["geom_bias", "geom_bias_bwd", "nms_keep_sorted"] + (
            [] if tiny else ["stem_conv1_bn_relu"])
        if (bad or len(step_ms) != 4 or not any(f for f, _, _ in seen)
                or any(d != np.uint8 or len(sh) != 3 or sh[0] != 12
                       for _, d, sh in seen)
                or any(counts[k] <= 0 for k in must)):
            fail(f"{tag} train driver: non-finite {bad}, {len(step_ms)} steps, "
                 f"batches {kinds} (flipped {[f for f, _, _ in seen]}), launches "
                 f"{counts}")

        # (c) the test driver on the newest params file
        ckpt = e2e.trained_params_path(yaml)
        stats = {}
        zero_counters()
        t0 = time.perf_counter()
        res, dets = test_driver.main(common + ["--ckpt", ckpt, "--thresh", "0"],
                                     image_loader=image_loader, stats=stats)
        torch.cuda.synchronize()
        driver_s = time.perf_counter() - t0
        counts = read_launches()
        add(counts)
        n = stats["images"]
        split = ", ".join(f"{k} {stats[k + '_s'] / n * 1e3:.3f}"
                          for k in ("data", "net", "fetch", "post"))
        n_dets = sum(len(d) for d in dets.values())
        log(f"{tag} (c) test driver on {os.path.basename(ckpt)}: {n} images in "
            f"{driver_s:.2f} s (model built and loaded included); ms/image "
            f"{split} (the reloaded model's first pass); "
            f"{n_dets} detections; summarize {stats['summarize_s'] * 1e3:.3f} ms "
            f"({'native' if stats['native'] else 'NumPy'} matching); AP "
            f"{res['AP']:.4f} AR100 {res['AR100']:.4f} (random weights); "
            f"launches {counts}; on {card}")

        # the trained model's own predictions on TestLoader's items
        model = trained["model"]
        del trained
        kw = {} if image_loader is None else {"image_loader": image_loader}
        items = list(TestLoader(roidb, cfg, **kw))
        predict = build_predict_fn(model, cfg)

        def direct_pass():
            out = {}
            for image_id, img, info in items:
                d = predict(img, info)["dets"].cpu().numpy()
                out[image_id] = d[d[:, 0] >= 0]
            return out
        zero_counters()
        direct = direct_pass()
        add(read_launches())
        same = lambda a, b: (a.keys() == b.keys()
                             and all(np.array_equal(a[k], b[k]) for k in a))
        if not same(dets, direct):
            fail(f"{tag} the reloaded params' detections differ from the "
                 f"trained model's")

        # (d) pred_eval of the trained model (warm), then the plain path
        stats_d = {}
        zero_counters()
        _, pe = pred_eval(model, cfg, dataset, roidb, stats=stats_d,
                          loader=TestLoader(roidb, cfg, **kw))
        add(read_launches())
        with plain_kernels():
            before = read_launches()
            plain = direct_pass()
            stray = launches_since(before)
        errs = [f"image {k}: {e}" for k in plain
                for e in match_dets(plain[k], direct[k])]
        warm = ", ".join(f"{k} {stats_d[k + '_s'] / stats_d['images'] * 1e3:.3f}"
                         for k in ("data", "net", "fetch", "post"))
        log(f"{tag} (c, d) reloaded params vs the trained model: bit-equal; "
            f"pred_eval (window {int(cfg.TPU.EVAL_PIPELINE_DEPTH)}, pinned "
            f"copies) vs direct predictor calls: "
            f"{'bit-equal' if same(pe, direct) else 'DIFFER'}; warm pass ms/image "
            f"{warm}; kernel vs plain top-{TOP_K} (IoU>={IOU_MIN}, "
            f"|ds|<={SCORE_ATOL}): "
            f"{'OK' if not errs else f'{len(errs)} mismatches'}; on {card}")
        if not same(pe, direct) or errs or stray:
            for e in errs[:20]:
                log(f"  {e}")
            fail(f"{tag} pred_eval differs from the direct calls, the kernel "
                 f"path leaves the plain path's bands, or the plain path "
                 f"launched kernels {stray}")
        if any(not np.isfinite(d).all() or d.shape[1] != 6 or not len(d)
               for d in dets.values()) or len(dets) != len(roidb):
            fail(f"{tag} bad detections: {[d.shape for d in dets.values()]}")
        del model, predict, items
        torch.cuda.empty_cache()

        # (e) the ground truth as detections; the NumPy matching route
        ev = CocoEvaluator(dataset)
        for e in roidb:
            keep = ~e["iscrowd"]
            ev.add_detections(e["image_id"], np.concatenate(
                [e["gt_classes"][keep, None].astype(np.float32),
                 np.ones((int(keep.sum()), 1), np.float32),
                 e["boxes"][keep]], 1))
        t0 = time.perf_counter()
        gt_res = ev.summarize()
        gt_ms = (time.perf_counter() - t0) * 1e3
        ap = {c: v for c, v in gt_res["per_class"].items() if v == v}
        want = {int(c) for e in roidb for c in e["gt_classes"][~e["iscrowd"]]}
        ev = CocoEvaluator(dataset)
        for k, d in dets.items():
            ev.add_detections(k, d)
        lib = native._lib
        native._lib = False
        try:
            t0 = time.perf_counter()
            numpy_res = ev.summarize()
            numpy_ms = (time.perf_counter() - t0) * 1e3
        finally:
            native._lib = lib
        agree = json.dumps(numpy_res, sort_keys=True) == json.dumps(
            res, sort_keys=True)
        log(f"{tag} (e) ground truth as detections: AP {gt_res['AP']:.4f}, "
            f"per-class AP {sorted(ap.items())} over the {len(want)} classes "
            f"with non-crowd boxes ({gt_ms:.3f} ms); the test driver's "
            f"detections on the NumPy route {numpy_ms:.3f} ms, results "
            f"{'equal to' if agree else 'DIFFERENT from'} the native route's; "
            f"on {card}")
        if (gt_res["AP"] != 1.0 or set(ap) != want or not agree
                or any(v != 1.0 for v in ap.values())):
            fail(f"{tag} the evaluator: AP {gt_res['AP']}, per class {ap}, "
                 f"classes {want}, routes agree {agree}")

        # (f) the cached-proposal path with a real loader: fpn_learn_nms
        fcfg = family_cfg("fpn_learn_nms", tiny_shapes=tiny)
        fcfg.TEST.HAS_RPN = False
        fcfg.TEST.SCORE_THRESH = 0.0
        fcfg.dataset.test_image_set = test_set
        if tiny:
            fcfg.SCALES[0] = (64, 96)
            fcfg.TPU.IMAGE_BUCKETS = [(64, 96), (96, 64)]
        fmodel = init_params(build_model(fcfg, tiny=tiny, device=dev), seed=0)
        first = next(iter(TestLoader(roidb[:1], fcfg, **kw)))
        calibrate_heads(fmodel, build_predict_fn(fmodel, fcfg),
                        first[1], first[2])
        torch.cuda.synchronize()
        pkl = "minival2014_rpn.pkl"
        zero_counters()
        t0 = time.perf_counter()
        generate_rpn_proposals(fmodel, fcfg, roidb, pkl, device=dev,
                               loader=None if use_pil else TestLoader(
                                   roidb, fcfg, **kw))
        torch.cuda.synchronize()
        dump_ms = (time.perf_counter() - t0) * 1e3 / len(roidb)
        dump_counts = read_launches()
        add(dump_counts)
        import pickle
        with open(pkl, "rb") as f:
            props = pickle.load(f)
        stats_f = {}
        zero_counters()
        _, fdets = pred_eval_rcnn(
            fmodel, fcfg, dataset, roidb, pkl, stats=stats_f,
            loader=None if use_pil else ProposalTestLoader(roidb, fcfg, pkl, **kw))
        torch.cuda.synchronize()
        rcnn_counts = read_launches()
        add(rcnn_counts)
        nf = stats_f["images"]
        fsplit = ", ".join(f"{k} {stats_f[k + '_s'] / nf * 1e3:.3f}"
                           for k in ("data", "net", "fetch", "post"))
        log(f"{tag} (f) fpn_learn_nms, cached proposals: the dump "
            f"(loader=None) {dump_ms:.3f} ms/image, {[len(p) for p in props]} "
            f"proposals; pred_eval_rcnn over {nf} images, TOP_ROIS "
            f"{int(fcfg.TEST.TOP_ROIS)}: ms/image {fsplit} (first pass); "
            f"{sum(len(d) for d in fdets.values())} detections; launches "
            f"dump {dump_counts}, pred_eval_rcnn {rcnn_counts}; on {card}")
        fmust = ["nms_keep_sorted", "geom_bias", "fused_bias_attention"] + (
            [] if tiny else ["stem_conv1_bn_relu"])
        if (len(props) != len(roidb) or any(len(p) == 0 or not np.isfinite(p).all()
                                            for p in props)
                or len(fdets) != len(roidb)
                or any(not np.isfinite(d).all() or not len(d)
                       for d in fdets.values())
                or any((dump_counts.get(k, 0) + rcnn_counts.get(k, 0)) <= 0
                       for k in fmust)):
            fail(f"{tag} the cached-proposal path: {len(props)} proposal sets, "
                 f"{len(fdets)} images with detections, launches "
                 f"{dump_counts} / {rcnn_counts}")
        del fmodel
        torch.cuda.empty_cache()
        log(f"[e2e] eval flagship: train step {statistics.median(step_ms[1:]):.3f} "
            f"ms (median of steps 2-4), test driver ms/image {split} (first "
            f"pass), warm pred_eval ms/image {warm}, summarize "
            f"{stats['summarize_s'] * 1e3:.3f} ms; fpn_learn_nms proposal dump "
            f"{dump_ms:.3f} ms/image, pred_eval_rcnn ms/image {fsplit}; on {card}")
    finally:
        os.chdir(cwd)
        tmp.cleanup()
    return launches


# --------------------------------------------------------------------------
# phases 14 and 15: data parallelism, and the reference-weights path
# --------------------------------------------------------------------------

def launches_of(counts: dict) -> dict:
    """COUNTERS names (and "name@shape") of a utils/trace.py::
    kernel_launches() snapshot taken in another process."""
    out = {name: counts.get(f"{mod}.{attr}", 0)
           for name, (mod, attr) in COUNTERS.items()}
    for name, (mod, attr) in SHAPES.items():
        for shape, v in counts.get(f"{mod}.{attr}", {}).items():
            out[f"{name}@{shape}"] = v
    return out


def mini_dataset(tiny: bool, seed: int, use_pil: bool | None = None):
    """Five test images of the flagship YAML's minival2014 at ./data/coco,
    three 480x640 and two 640x480 (two buckets, an odd count; 48x64 and
    64x48 for a rehearsal): PNG files where PIL imports, else None files
    and the arrays to hand the loaders. Returns (arrays or None, route)."""
    from relation_tpu_torch.data.coco import COCO_CAT_IDS
    from relation_tpu_torch.tools.mini_coco import write_mini_coco
    if use_pil is None:
        try:
            import PIL  # noqa: F401
            use_pil = True
        except ImportError:
            use_pil = False
    land, port = ((48, 64), (64, 48)) if tiny else ((480, 640), (640, 480))
    arrays = write_mini_coco("data/coco", {"minival2014": [land] * 3 + [port] * 2},
                             seed=seed, all_cat_ids=COCO_CAT_IDS, png=use_pil)
    return (None if use_pil else arrays,
            "PNG files" if use_pil else "arrays handed to the loaders")


def run_dp(torch, dev, card: str = "", tiny: bool = False):
    """Phase 14: data parallelism over torch.distributed. Two gloo ranks
    spawned on the one card (parallel/launch.py::spawn, a file:// store;
    NCCL refuses two ranks on one GPU), each on cuda:0.
    (a) Train: the flagship YAML (TPU.GRAD_CLIP 10, convs and head in f32:
    a bf16 step is not reproducible to 1e-3), init_params(seed=0), a
    state seeded with 0, one global batch of two 608x1024 s2d images with
    three boxes each, one image a rank, three steps; the first step against
    one process's step on the same two images: every loss within 1e-3
    relative, the update's global L2 norm within 1e-3, every leaf's update
    within 1e-3 of the update's global norm, both ranks' parameters
    bit-equal (sha256 of every tensor). ms/step of both routes: the median
    of steps 2 and 3.
    (b) Inference: pred_eval over the process group (one image of each
    same-bucket pair a rank, the partial group padded) on a seeded mini COCO
    dataset of five images in two buckets, init_params(seed=0) weights in
    the YAML's dtypes, score threshold 0, against the sequential pred_eval:
    bit-equal expected; where not, reported and held to phase 4's top-50
    bands. ms/image (net) of both routes; the two ranks share the card.
    The launches of both routes, both ranks' read from their processes.
    ``tiny``: the tiny trunk at 64x128 and 48x64 on the CPU."""
    import tempfile

    from relation_tpu_torch.config.defaults import load_config
    from relation_tpu_torch.entry import BUCKET
    from relation_tpu_torch.parallel.launch import (pred_eval_rank, spawn,
                                                    train_and_eval_rank,
                                                    train_steps, update_agreement)
    from relation_tpu_torch.parallel.mesh import make_mesh
    tag = "[dp]"
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_dp_")
    cwd = os.getcwd()
    os.chdir(tmp.name)
    try:
        arrays, route = mini_dataset(tiny, seed=14)
        yaml = eval_yaml("flagship.yaml", tiny)
        train_cfg = load_config(yaml)
        train_cfg.TPU.COMPUTE_DTYPE = train_cfg.TPU.HEAD_DTYPE = "float32"
        eval_cfg = load_config(yaml)
        eval_cfg.TEST.SCORE_THRESH = 0.0
        H, W = (64, 128) if tiny else BUCKET
        batch = training_batch(H, W, B=2, n_gt=3)
        one = make_mesh(device=dev)
        zero_counters()
        ref = train_steps(one, train_cfg, batch, tiny=tiny, steps=3)
        seq = pred_eval_rank(one, eval_cfg, "data/coco", "minival2014",
                             tiny=tiny, arrays=arrays)
        add(read_launches())
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = spawn(train_and_eval_rank, 2, train_cfg, batch, 3, eval_cfg,
                      "data/coco", "minival2014", tiny, arrays,
                      backend="gloo", device=str(dev))
        spawn_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        tmp.cleanup()
    for r in ranks:
        add(launches_of(r["launches"]))
    if not tiny:
        for i, r in enumerate(ranks):
            trained = launches_of(r["train_launches"])
            served = {k: launches_of(r["launches"])[k] - trained[k]
                      for k in COUNTERS}
            idle = ([k for k in ("geom_bias", "geom_bias_bwd", "nms_keep_sorted",
                                 "fused_bias_attention") if not trained[k]]
                    + [k for k in ("geom_bias", "nms_keep_sorted",
                                   "stem_conv1_bn_relu") if not served[k]])
            if idle:
                fail(f"{tag} rank {i} launched none of {idle}")
    # (a) the step
    digests = {r["train"]["digest"] for r in ranks}
    dp = ranks[0]["train"]
    m_dp, m_ref = dp["metrics"][0], ref["metrics"][0]
    worst = max((abs(m_dp[k] - v) / max(abs(v), 1e-6), k)
                for k, v in m_ref.items() if k.endswith("loss"))
    agree = update_agreement(ref["init"], ref["params"], dp["params"])
    norm_err = abs(agree["norm_new"] - agree["norm"]) / agree["norm"]
    ok = (len(digests) == 1 and worst[0] <= 1e-3 and norm_err <= 1e-3
          and agree["leaf_of_norm"] <= 1e-3 and agree["moved"] > 0)
    ms_one = statistics.median(ref["step_s"][1:]) * 1e3
    ms_dp = statistics.median(dp["step_s"][1:]) * 1e3
    log(f"{tag} (a) train step, global batch 2 = 2 ranks x 1 (gloo on one "
        f"card) vs one process x 2, f32: total_loss {m_dp['total_loss']:.6f} "
        f"vs {m_ref['total_loss']:.6f}, worst loss {worst[1]} rel "
        f"{worst[0]:.2e}; update norm {agree['norm_new']:.6e} vs "
        f"{agree['norm']:.6e} rel {norm_err:.2e}, whole update rel "
        f"{agree['global_rel']:.2e}, worst leaf {agree['leaf_of_norm']:.2e} of "
        f"the norm, {agree['moved']} leaves moved; ranks bit-equal "
        f"{len(digests) == 1} (tol 1e-3) {'OK' if ok else 'FAIL'}")
    log(f"{tag} (a) ms/step (median of steps 2-3): one process, B=2: "
        f"{ms_one:.3f}; data parallel, 2 ranks x B=1 on one card: {ms_dp:.3f} "
        f"(rank 1: {statistics.median(ranks[1]['train']['step_s'][1:]) * 1e3:.3f});"
        f" on {card}")
    if not ok:
        fail(f"{tag} the data-parallel step disagrees with one process's step")
    # (b) pred_eval
    want = seq["dets"]
    n_det = sum(len(d) for d in want.values())
    equal = all(list(r["eval"]["dets"]) == list(want) and all(
        np.array_equal(r["eval"]["dets"][k], v) for k, v in want.items())
        for r in ranks)
    errs = [] if equal else [
        f"image {k}: {e}" for r in ranks for k, v in want.items()
        for e in match_dets(v, r["eval"]["dets"].get(k, np.zeros((0, 6))))]
    st = [seq["stats"]] + [r["eval"]["stats"] for r in ranks]
    per = [s["net_s"] / max(s["images"], 1) * 1e3 for s in st]
    log(f"{tag} (b) pred_eval over 2 ranks vs sequential, {len(want)} images "
        f"({route}), {n_det} detections: bit-equal {equal}"
        + ("" if equal else f", top-{TOP_K} bands: {len(errs)} misses {errs[:3]}")
        + f"; ms/image (net): sequential {per[0]:.3f}, data parallel rank 0 "
        f"{per[1]:.3f}, rank 1 {per[2]:.3f} (both ranks on one card); "
        f"spawn to join {spawn_s:.1f} s; on {card}")
    if n_det == 0 or errs:
        fail(f"{tag} data-parallel pred_eval disagrees with the sequential run")
    return launches


def run_reference(torch, dev, card: str = "", tiny: bool = False):
    """Phase 15: the reference-weights path. (a) The flagship YAML's model
    with init_params(seed=0), written as an mx.nd.save v2 file under the
    reference's names and MXNet layouts (relation_tpu_torch/tools/
    convert_reference_params.py::reference_arrays, 'arg:' / 'aux:'
    prefixes); (b) converted by that tool (its main, as a user runs it):
    nothing missing, nothing unused, the params file read back into a fresh
    model bit-equal to the weights written; (c) ``python -m
    relation_tpu_torch.experiments.test --roi-method auto`` on a seeded
    mini COCO dataset (five images, two buckets), in a process of its own:
    it must pick roi_method pool and the parity keys (FPN_TOPK exact,
    GEOM_EMB_DTYPE float32, NMS_COMPACT_CLASSES 0, DCN_POOL_DTYPE float32);
    (d) the same requests in this process, pred_eval with the kernels and
    with the plain versions (roi_pool's among them), held to phase 4's
    top-50 bands, the driver's detections against the kernel run's; the
    parity mode's ms/image; (e) two clipped flagship train steps and one
    unclipped pair with TPU.ROI_METHOD='pool' (run_training: the ROIPooling
    forward and backward kernels once an image a step, kernel step against
    plain step within 1e-3). ``tiny``: the tiny trunk on the CPU."""
    import pickle
    import tempfile

    from relation_tpu_torch.config.defaults import load_config
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.checkpoint import (load_params,
                                                    params_from_blob,
                                                    read_params_blob)
    from relation_tpu_torch.core.evaluator import pred_eval
    from relation_tpu_torch.core.trainer import build_model
    from relation_tpu_torch.data.coco import coco_dataset
    from relation_tpu_torch.data.loader import TestLoader
    from relation_tpu_torch.experiments.test import ROI_KEYS, apply_roi_method
    from relation_tpu_torch.tools import convert_reference_params as conv
    from relation_tpu_torch.tools.mini_coco import array_loader
    tag = "[reference]"
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_ref_")
    cwd = os.getcwd()
    os.chdir(tmp.name)
    try:
        arrays, route = mini_dataset(tiny, seed=15)
        yaml = eval_yaml("flagship.yaml", tiny)
        tiny_flag = ["--tiny"] if tiny else []
        # (a) + (b)
        cfg = load_config(yaml)
        model = init_params(build_model(cfg, tiny=tiny, device=dev), seed=0)
        src = conv.save_mxnet_params("rcnn_coco-0008.params",
                                     conv.reference_arrays(model), "v2")
        t0 = time.perf_counter()
        out = conv.main(["--src", src, "--cfg", yaml, "--out",
                         "ref.params.msgpack", "--device", dev.type, *tiny_flag])
        conv_s = time.perf_counter() - t0
        fresh = build_model(cfg, tiny=tiny, device=dev)
        fresh.load_state_dict(load_params(out["out"], fresh))
        sd = model.state_dict()
        diff = [k for k, v in fresh.state_dict().items()
                if not torch.equal(v, sd[k])]
        n_arrays = len(sd)
        del model, fresh, out["model"]
        log(f"{tag} (a-b) {n_arrays} arrays written as mx.nd.save v2 "
            f"({os.path.getsize(src) / 2 ** 20:.1f} MiB), converted in "
            f"{conv_s:.1f} s: {len(out['missing'])} missing, "
            f"{len(out['unused'])} unused, {len(diff)} leaves differ after the "
            f"round trip")
        if out["missing"] or out["unused"] or diff:
            fail(f"{tag} the converter's round trip is not exact: missing "
                 f"{out['missing'][:3]}, unused {out['unused'][:3]}, differ "
                 f"{diff[:3]}")
        # (c) the test driver in a process of its own
        if arrays is not None:
            fail(f"{tag} needs PIL: experiments.test reads the dataset's PNG "
                 "files")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [HERE] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                      if p]))
        cmd = [sys.executable, "-m", "relation_tpu_torch.experiments.test",
               "--cfg", yaml, "--ckpt", "ref.params.msgpack", "--roi-method",
               "auto", "--thresh", "0", "--device", dev.type, *tiny_flag]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                              env=env)
        driver_s = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"{tag} experiments.test failed ({proc.returncode}): "
                 f"{proc.stderr[-2000:]}")
        picked = [json.loads(line.split("ROI settings: ", 1)[1])
                  for line in proc.stdout.splitlines()
                  if line.startswith("ROI settings: ")]
        want_keys = {"ROI_METHOD": "pool", "FPN_TOPK": "exact",
                     "GEOM_EMB_DTYPE": "float32", "NMS_COMPACT_CLASSES": 0,
                     "DCN_POOL_DTYPE": "float32"}
        log(f"{tag} (c) python -m relation_tpu_torch.experiments.test "
            f"--roi-method auto: {driver_s:.1f} s, picked {picked}")
        if picked != [want_keys]:
            fail(f"{tag} the test driver's parity mode set {picked}, not "
                 f"{want_keys}")
        test_set = cfg.dataset.test_image_set
        with open(os.path.join(cfg.output_path or "output", "flagship", test_set,
                               "detections.pkl"), "rb") as f:
            driver_dets = pickle.load(f)
        # (d) in this process, kernels and plain versions
        pcfg = load_config(yaml)
        blob, meta = read_params_blob("ref.params.msgpack")
        apply_roi_method(pcfg, "auto", meta)
        pcfg.TEST.SCORE_THRESH = 0.0
        if {k: pcfg.TPU.get(k) for k in ROI_KEYS} != want_keys:
            fail(f"{tag} apply_roi_method set "
                 f"{ {k: pcfg.TPU.get(k) for k in ROI_KEYS} }")
        model = build_model(pcfg, tiny=tiny, device=dev)
        model.load_state_dict(params_from_blob(blob, model))
        dataset = coco_dataset(pcfg.dataset.dataset_path, test_set)
        roidb = dataset.roidb()

        def loader():
            return (None if arrays is None else
                    TestLoader(roidb, pcfg, image_loader=array_loader(arrays)))
        stats = {}
        zero_counters()
        _, kdets = pred_eval(model, pcfg, dataset, roidb, loader=loader(),
                             stats=stats)
        served = read_launches()
        add(served)
        with plain_kernels():
            zero_counters()
            pstats = {}
            _, pdets = pred_eval(model, pcfg, dataset, roidb, loader=loader(),
                                 stats=pstats)
            stray = {k: read_counter(k) for k in COUNTERS if read_counter(k)}
    finally:
        os.chdir(cwd)
        tmp.cleanup()
    if stray:
        fail(f"{tag} the plain pred_eval launched kernels: {stray}")
    # the learned-NMS attention: the skip kernel when at most half the
    # classes pass the class threshold, else the geometric bias + the bias
    # attention (NMS_COMPACT_CLASSES 0 changes only the XLA branch's form)
    idle = [k for k in ("roi_pool", "nms_keep_sorted", "geom_bias",
                        "stem_conv1_bn_relu") if not served[k]]
    if not (served["fused_nms_relation_attention_skip"]
            or served["fused_bias_attention"]):
        idle.append("the learned-NMS attention")
    if not tiny and idle:
        fail(f"{tag} the parity-mode pred_eval launched none of {idle}: "
             f"{served}")
    errs = [f"image {k}: {e}" for k, v in pdets.items()
            for e in match_dets(v, kdets[k])]
    same_driver = list(driver_dets) == list(kdets) and all(
        np.array_equal(driver_dets[k], v) for k, v in kdets.items())
    errs += [] if same_driver else [
        f"driver image {k}: {e}" for k, v in kdets.items()
        for e in match_dets(v, driver_dets[k])]
    n_det = sum(len(d) for d in kdets.values())
    per = stats["net_s"] / max(stats["images"], 1) * 1e3
    plain_per = pstats["net_s"] / max(pstats["images"], 1) * 1e3
    log(f"{tag} (d) parity-mode pred_eval ({route}, {len(kdets)} images, {n_det} "
        f"detections): kernel path vs plain path in the top-{TOP_K} bands: "
        f"{len(errs)} misses {errs[:3]}; the driver's detections bit-equal to "
        f"this process's: {same_driver}; ms/image (net) {per:.3f} (plain path "
        f"{plain_per:.3f}); roi_pool launches {served['roi_pool']} (by shape: "
        f"{ {k: v for k, v in served.items() if k.startswith('roi_pool@')} }); "
        f"on {card}")
    if errs or n_det == 0:
        fail(f"{tag} the parity-mode detections leave the bands")
    # (e) the train step on ROIPooling
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    counts, ms, peak = run_training(torch, dev, card, tiny=tiny,
                                    dense_steps=2, fused_steps=0,
                                    roi_method="pool")
    add(counts)
    log(f"{tag} (e) flagship train step with TPU.ROI_METHOD='pool', B=2: "
        f"{ms:.3f} ms/step, peak memory {peak:.3f} GiB on {card}")
    return launches, per


# --------------------------------------------------------------------------
# phase 16: the production-shape gate, and every cut of the train steps
# --------------------------------------------------------------------------

def run_gate(torch, dev, card: str = "", tiny: bool = False):
    """The production-shape gate (relation_tpu_torch/tools/flagship_golden.py)
    on init_params (seed 0) weights with the four prediction layers scaled
    by the factors of tests/golden/flagship_port.npz on the host, two
    requests through entry() at 608x1024 on the kernels: (1) in f32, its
    detections held against the JAX package's in that file in the bands of
    tools/flagship_golden.py (IoU >= 0.95, |score delta| <= 2e-2, the mean
    top-50 score within 5e-3, the count within max(2, 5%)), the NMS, the
    geometric bias and the learned-NMS attention launched; (2) in the
    flagship's own configuration (bf16 trunk), its head feature at
    trunk_sample's rows and columns within TRUNK_RTOL of the JAX package's
    bf16 one, the stem kernel launched. ``tiny`` (a rehearsal): the tiny
    trunk on a 64x128 image with factors calibrated on it, no golden to hold
    it to. Returns the launch counts of both requests."""
    from relation_tpu_torch.tools import flagship_golden as gate
    from relation_tpu_torch.tools.calibrate import calibrate_heads
    tag = "[gate]"
    with np.load(gate.GOLDEN) as z:
        gold = {k: z[k] for k in z.files}
    size = (64, 128) if tiny else (608, 1024)
    if tiny:
        from relation_tpu_torch.convert import init_params
        from relation_tpu_torch.core.predictor import build_predict_fn
        from relation_tpu_torch.core.trainer import build_model
        cfg = gate.gate_cfg(tiny=True)
        model = init_params(build_model(cfg, tiny=True, device=dev), gate.SEED)
        gold["factors"] = calibrate_heads(
            model, build_predict_fn(model, cfg),
            torch.tensor(gate.gate_image(size), device=dev),
            torch.tensor(gate.IM_INFO, device=dev))
    zero_counters()
    t0 = time.perf_counter()
    new = gate.port_dets(gold["factors"], device=dev, tiny=tiny, size=size)
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    used = {k: v for k, v in launches.items() if v}
    log(f"{tag} flagship at {size[0]}x{size[1]} in f32 through entry(), "
        f"factors {gold['factors'].tolist()}: {len(new)} detections, "
        f"{ms:.1f} ms with the model's build; launches {used}; on {card}")
    if not len(new) or not np.isfinite(new).all():
        fail(f"{tag} no or non-finite detections")
    attention = (launches["fused_nms_relation_attention_skip"]
                 + launches["fused_bias_attention"])
    idle = [k for k in ("nms_keep_sorted", "geom_bias") if not launches[k]]
    if not attention:
        idle.append("the learned-NMS attention")
    if idle:
        fail(f"{tag} the request launched none of {idle}")
    zero_counters()
    t0 = time.perf_counter()
    trunk = gate.port_trunk(gold["factors"], device=dev, tiny=tiny, size=size)
    ms = (time.perf_counter() - t0) * 1e3
    bf16 = read_launches()
    log(f"{tag} flagship in its own configuration (bf16 trunk): head feature "
        f"sample {trunk.shape}, mean |x| {np.abs(trunk).mean():.4f}, {ms:.1f} "
        f"ms with the model's build; launches "
        f"{ {k: v for k, v in bf16.items() if v} }")
    if not np.isfinite(trunk).all():
        fail(f"{tag} non-finite bf16 trunk feature")
    if not tiny and not bf16["stem_conv1_bn_relu"]:
        fail(f"{tag} the bf16 request launched no stem kernel")
    for k, v in bf16.items():
        launches[k] = launches.get(k, 0) + v
    if tiny:
        log(f"{tag} rehearsal: the golden is for 608x1024, no comparison")
        return launches
    errs, margins = gate.compare(new, gold["dets"], int(gold["n_dets"]),
                                 float(gold["mean_top50"]))
    trunk_errs, rel = gate.hold_trunk(trunk, gold["trunk_bf16"])
    log(f"{tag} against tests/golden/flagship_port.npz (the JAX package's "
        f"answer, {int(gold['n_dets'])} detections, mean top-{TOP_K} "
        f"{float(gold['mean_top50']):.6f}): {len(errs)} misses; worst IoU "
        f"{margins['worst_iou']:.6f}, worst |score delta| "
        f"{margins['worst_dscore']:.3e}, mean top-{TOP_K} "
        f"{margins['mean_top50']:.6f}; bf16 head feature {rel:.4e} from "
        f"JAX's (mean |delta| / mean |x|, band {gate.TRUNK_RTOL:g})")
    if errs or trunk_errs:
        for e in (errs + trunk_errs)[:20]:
            log(f"  {e}")
        fail(f"{tag} the port leaves the gate's bands")
    return launches


# the parameter groups of a model (by the first component of a name) and
# the groups each cut's graph reaches
GROUPS = {"c4": "trunk", "c5": "res5", "conv_new_1": "res5", "neck": "neck",
          "rpn": "rpn", "fc_new_1": "head", "fc_new_2": "head",
          "roi_pool_fc1": "head", "roi_pool_fc2": "head", "relation_1": "head",
          "relation_2": "head", "cls_score": "head", "bbox_pred": "head",
          "offset": "head"}
LNMS_GROUPS = {"nms_rank": "lnms_embed", "roi_feat_embedding": "lnms_embed",
               "NMSRelationModule_0": "lnms_attn", "nms_logit": "lnms_logit"}


def param_group(name: str) -> str:
    parts = name.split(".")
    if parts[0] == "learn_nms_head":
        return LNMS_GROUPS[parts[1]]
    return GROUPS[parts[0]]


def reached_groups(cut: str, rcnn: bool) -> set:
    """The groups whose trainable leaves the cut's loss reaches."""
    if rcnn:
        trunk = {"trunk", "res5", "neck"}
        return {"trunk": trunk, "sample": set(), "pool": trunk,
                "head": trunk | {"head"},
                "": trunk | {"head", "lnms_embed", "lnms_attn",
                             "lnms_logit"}}[cut]
    from relation_tpu_torch.core.trainer import STOP_AFTER
    order = STOP_AFTER + ("",)
    i = order.index(cut)
    out = {"trunk", "rpn"}
    for stage, groups in (("feat", {"res5"}), ("head", {"head"}),
                          ("lnms_embed", {"lnms_embed"}),
                          ("lnms_attn", {"lnms_attn"}),
                          ("lnms_score", {"lnms_logit"})):
        if i >= order.index(stage):
            out |= groups
    return out


def cut_step(torch, dev, model, cfg, start, make, batch, cut, label, tag,
             rcnn: bool, tiny: bool):
    """One step of one cut from the weights ``start`` without weight decay:
    finite metrics, a pure tap's loss at most 1e-20, autograd's gradients
    delivered to exactly the groups the cut reaches, every leaf it does not
    reach bit-equal after the step. Returns (metrics, launches, host ms,
    device ms, the learned-NMS leaves' largest |gradient|)."""
    from relation_tpu_torch.core.trainer import create_train_state
    model.load_state_dict(start)
    state = create_train_state(model, cfg, seed=0)
    trainable = [n for n, on in state.tx.mask.items() if on]
    present = {param_group(n) for n in trainable}
    delivered = set()
    params = dict(model.named_parameters())
    hooks = [params[n].register_post_accumulate_grad_hook(
        lambda _p, n=n: delivered.add(n)) for n in trainable]
    step = make(cut)
    zero_counters()
    cuda = dev.type == "cuda"
    try:
        if cuda:
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            e0.record()
        t0 = time.perf_counter()
        _, m = step(state, batch)
        if cuda:
            e1.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        dev_ms = e0.elapsed_time(e1) if cuda else float("nan")
    finally:
        for h in hooks:
            h.remove()
    launches = read_launches()
    m = {k: float(v) for k, v in m.items()}
    bad = [k for k, v in m.items() if not np.isfinite(v)]
    if bad:
        fail(f"{tag} {label}: non-finite metrics {bad}")
    if rcnn and cut in ("trunk", "sample", "pool") and not (
            abs(m["total_loss"]) <= 1e-20):
        fail(f"{tag} {label}: total_loss {m['total_loss']} of a 1e-30 tap")
    want = reached_groups(cut, rcnn) & present
    got = {param_group(n) for n in delivered}
    if got != want:
        fail(f"{tag} {label}: gradients reached {sorted(got)}, the cut reaches "
             f"{sorted(want)}")
    end = model.state_dict()
    moved = [n for n in trainable if n not in delivered
             and not torch.equal(end[n], start[n])]
    if moved:
        fail(f"{tag} {label}: leaves the cut does not reach moved: {moved[:5]}")
    lnms_grad = max((float(state.trace[n].abs().max()) for n in delivered
                     if n.startswith("learn_nms_head.")), default=0.0)
    return m, launches, host_ms, dev_ms, lnms_grad


def run_cuts(torch, dev, card: str = "", tiny: bool = False):
    """Every stop_after cut once on the card at full width, B=2, with the
    cfg edits of tools/train_cuts.py (lr 1e-5, no warm-up, TPU.GRAD_CLIP 1)
    and no weight decay, each step from the same weights (cut_step's
    checks): (a) the flagship end-to-end step's eleven cuts and the full
    step, and lnms_attn again with the fully fused attention; the launch
    counters show no geometric bias or attention before 'head', only the
    relation modules' (C=1) at 'head' and lnms_embed, rows 1, 2 and 7 at
    the learned-NMS branch's C=80 from lnms_attn on (row 6 under
    fully_fused); (b) the fpn_learn_nms RCNN step on 1000 cached ROIs
    (TOP_ROIS; calibrated prediction layers): 'trunk', 'sample', 'pool',
    'head' and the full step; the pure taps' losses at most 1e-20, the
    learned-NMS branch's kernels only in the full step. Prints each cut's
    ms on the host clock and by CUDA events (one step, a first call of the
    cut). ``tiny``: the tiny trunk and proposal counts on 64x128 images.
    Returns the launch counts summed over the cuts."""
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.predictor import build_predict_fn
    from relation_tpu_torch.core.rpn_workflow import (STOP_AFTER_RCNN,
                                                      make_train_step_rcnn)
    from relation_tpu_torch.core.trainer import (STOP_AFTER, build_model,
                                                 make_train_step)
    from relation_tpu_torch.tools.calibrate import calibrate_heads
    from relation_tpu_torch.tools.train_cuts import (R_CACHED, family_config,
                                                     make_batch)
    size = (64, 128) if tiny else (608, 1024)
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    def c80(launches, name):
        return sum(v for k, v in launches.items()
                   if k.startswith(name + "@C=80"))

    attention = ("fused_nms_relation_attention", "fused_nms_relation_attention_skip",
                 "fused_bias_attention", "fused_bias_attention_skip")
    # (a) the flagship's end-to-end step
    tag = "[cuts flagship]"
    cfg = family_config("flagship", tiny=tiny)
    cfg.TRAIN.wd = 0.0
    model = init_params(build_model(cfg, tiny=tiny, device=dev), seed=0)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    batch = training_batch(*size)
    nms_mod = model.learn_nms_head.NMSRelationModule_0
    legs = [(c, c or "full", False) for c in STOP_AFTER + ("",)]
    legs.insert(STOP_AFTER.index("lnms_attn") + 1,
                ("lnms_attn", "lnms_attn fully_fused", True))
    rows = []
    for cut, label, fused in legs:
        nms_mod.fully_fused = fused
        m, launches, host_ms, dev_ms, lnms_grad = cut_step(
            torch, dev, model, cfg, start,
            lambda c: make_train_step(model, cfg, stop_after=c, device=dev),
            batch, cut, label, tag, rcnn=False, tiny=tiny)
        add(launches)
        i = (STOP_AFTER + ("",)).index(cut)
        rows.append((label, host_ms, dev_ms))
        geom, attn = launches["geom_bias"], sum(launches[k] for k in attention)
        errs = []
        if i < STOP_AFTER.index("head") and (geom or launches["geom_bias_bwd"]
                                             or attn):
            errs.append("a geometric bias or an attention before 'head'")
        if i >= STOP_AFTER.index("head") and not (geom and launches["geom_bias_bwd"]):
            errs.append("no geometric bias (rows 1, 2) in the head")
        if i <= STOP_AFTER.index("lnms_embed") and (c80(launches, "geom_bias")
                                                    or attn):
            errs.append("the learned-NMS attention ran")
        if i >= STOP_AFTER.index("lnms_attn"):
            want = (["fused_nms_relation_attention"] if fused else
                    ["fused_bias_attention", "geom_bias@C=80", "geom_bias_bwd@C=80"])
            short = [k for k in want if not (c80(launches, k.split("@")[0])
                                             if "@" in k else launches[k])]
            if short:
                errs.append(f"the learned-NMS branch launched none of {short}")
        if i >= STOP_AFTER.index("proposals") and not launches["nms_keep_sorted"]:
            errs.append("no proposal NMS")
        if not tiny and not launches["stem_conv1_bn_relu"]:
            errs.append("no stem")
        log(f"{tag} {label}: host {host_ms:.3f} ms, CUDA events (host-synced) "
            f"{dev_ms:.3f} ms; "
            f"total_loss {m['total_loss']:.6g}; learned-NMS leaves' largest "
            f"|gradient| {lnms_grad:.3e}; launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        if errs:
            fail(f"{tag} {label}: {'; '.join(errs)}")
    nms_mod.fully_fused = False
    del model, start
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # (b) the fpn_learn_nms RCNN step on cached ROIs
    tag = "[cuts fpn rcnn]"
    cfg = family_config("fpn", tiny=tiny)
    cfg.TRAIN.wd = 0.0
    model = init_params(build_model(cfg, tiny=tiny, device=dev), seed=0)
    batch = make_batch(cfg, 2, size, fpn=True)
    calibrate_heads(model, build_predict_fn(model, cfg),
                    torch.tensor(batch["image"][0], device=dev),
                    torch.tensor(batch["im_info"][0], device=dev))
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    R = batch["rois"].shape[1]
    for cut in STOP_AFTER_RCNN + ("",):
        label = cut or "full"
        m, launches, host_ms, dev_ms, _ = cut_step(
            torch, dev, model, cfg, start,
            lambda c: make_train_step_rcnn(model, cfg, max_rois=R_CACHED,
                                           max_gt=batch["gt_boxes"].shape[1],
                                           stop_after=c, device=dev),
            batch, cut, label, tag, rcnn=True, tiny=tiny)
        add(launches)
        rows.append((f"fpn rcnn {label}", host_ms, dev_ms))
        geom, attn = launches["geom_bias"], sum(launches[k] for k in attention)
        errs = []
        if cut in ("trunk", "sample", "pool") and (geom or attn):
            errs.append("a geometric bias or an attention before 'head'")
        if cut in ("head", "") and not (geom and launches["geom_bias_bwd"]):
            errs.append("no geometric bias (rows 1, 2) in the head")
        if (cut == "") != bool(c80(launches, "geom_bias")
                               and launches["fused_bias_attention"]):
            errs.append("the learned-NMS branch ran "
                        + ("nowhere" if cut == "" else "before the full step"))
        log(f"{tag} {label}, R={R}: host {host_ms:.3f} ms, CUDA events "
            f"(host-synced) {dev_ms:.3f} ms; total_loss {m['total_loss']:.6g}; launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        if errs:
            fail(f"{tag} {label}: {'; '.join(errs)}")
    del model, start
    log("[cuts] ms of one step (a first call of each cut), host clock / CUDA "
        f"events (host-synced: no device time), B=2, on {card}: " + "; ".join(
            f"{label} {h:.3f} / {d:.3f}" for label, h, d in rows))
    return total



def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=["all", "kernels", "dcn", "trunk", "fpn",
                                        "workflow", "eval", "dp", "reference",
                                        "cuts"],
                    default="all")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    sys.path.insert(0, HERE)
    try:
        from relation_tpu_torch.ops.kernels import _build
    except ImportError as e:
        fail(f"relation_tpu_torch not found beside chip_smoke.py ({e})")
    if not _build.CSRC.is_relative_to(os.path.realpath(HERE)):
        fail(f"relation_tpu_torch was imported from {_build.CSRC.parent}, not "
             f"from the checkout beside chip_smoke.py ({HERE})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    build_s = _build.build_all()
    log(f"[build] {len(_build.SOURCES)} sources ({len(COUNTERS)} kernels) "
        f"built in {build_s:.1f} s")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # the four kernels of the inference path share one seeded stream, in
    # this order; each later kernel draws from a stream of its own
    rng = np.random.RandomState(0)
    csrc = "relation_tpu_torch/csrc/"
    pallas = "relation_tpu/ops/pallas/"
    checks = {
        "geom_bias": (csrc + "geom_bias.cu", pallas + "geom_bias.py:275",
                      check_geom_bias, rng),
        "nms_keep_sorted": (csrc + "nms_kernel.cu", pallas + "nms_kernel.py:118",
                            lambda t, d, r: check_nms(t, d, r, nms_ran),
                            rng),
        "stem_conv1_bn_relu": (csrc + "stem.cu", pallas + "stem.py:67",
                               check_stem, rng),
        "fused_nms_relation_attention_skip": (
            csrc + "nms_attention.cu", pallas + "nms_attention.py:317",
            check_attention, rng),
        "geom_bias_bwd": (csrc + "geom_bias_bwd.cu", pallas + "geom_bias.py:219",
                          check_geom_bias_bwd, np.random.RandomState(1)),
        "fused_nms_relation_attention": (
            csrc + "nms_attention.cu", pallas + "nms_attention.py:136",
            check_attention_full, np.random.RandomState(2)),
        "dconv_col2im": (csrc + "dconv_col2im.cu", pallas + "dconv_col2im.py:71",
                         check_col2im, np.random.RandomState(3)),
        "fused_bottleneck_stack": (csrc + "bottleneck.cu", pallas + "res4.py:126",
                                   check_stack, np.random.RandomState(5)),
        "fused_proj_bottleneck": (csrc + "bottleneck.cu",
                                  pallas + "bottleneck_proj.py:86", check_proj,
                                  np.random.RandomState(6)),
        "fused_geometric_bias_skip": (csrc + "geom_bias.cu",
                                      pallas + "geom_bias.py:311",
                                      check_geom_bias_skip,
                                      np.random.RandomState(7)),
        "fused_bias_attention": (csrc + "bias_attention.cu",
                                 pallas + "nms_attention.py:239",
                                 check_bias_attention, np.random.RandomState(8)),
        "fused_bias_attention_skip": (csrc + "bias_attention.cu",
                                      pallas + "nms_attention.py:269",
                                      check_bias_attention_skip,
                                      np.random.RandomState(9)),
        # no Pallas counterpart: the JAX function is plain jnp
        "roi_pool": (csrc + "roi_pool.cu", "relation_tpu/ops/roi_pool.py:246",
                     check_roi_pool, np.random.RandomState(10)),
    }
    if args.phase == "dcn":
        checks = {"dconv_col2im": checks["dconv_col2im"]}
    if args.phase == "trunk":
        checks = {k: checks[k] for k in ("fused_bottleneck_stack",
                                         "fused_proj_bottleneck")}
    if args.phase == "fpn":
        checks = {k: checks[k] for k in (
            "geom_bias", "geom_bias_bwd", "fused_nms_relation_attention_skip",
            "fused_geometric_bias_skip", "fused_bias_attention",
            "fused_bias_attention_skip")}
    if args.phase == "workflow":
        checks = {k: checks[k] for k in (
            "geom_bias", "nms_keep_sorted", "stem_conv1_bn_relu", "geom_bias_bwd",
            "fused_bias_attention")}
    if args.phase == "eval":
        checks = {k: checks[k] for k in (
            "geom_bias", "nms_keep_sorted", "stem_conv1_bn_relu", "geom_bias_bwd",
            "fused_bias_attention", "fused_nms_relation_attention_skip")}
    if args.phase in ("dp", "reference"):
        checks = {k: checks[k] for k in (
            "geom_bias", "nms_keep_sorted", "stem_conv1_bn_relu", "geom_bias_bwd",
            "fused_bias_attention", "fused_nms_relation_attention_skip",
            "roi_pool")}
    if args.phase == "cuts":
        checks = {k: checks[k] for k in (
            "geom_bias", "nms_keep_sorted", "stem_conv1_bn_relu", "geom_bias_bwd",
            "fused_bias_attention", "fused_nms_relation_attention_skip",
            "fused_nms_relation_attention")}
    nms_ran = (nms_kernels_a_call(torch, dev)
               if args.phase in ("all", "kernels", "dcn", "workflow", "eval",
                                 "dp", "reference", "cuts")
               else {})
    results = {name: fn(torch, dev, r) for name, (_, _, fn, r) in checks.items()}
    if args.phase in ("all", "kernels", "dcn"):
        check_nms_classic(torch, dev, np.random.RandomState(4),
                          nms_ran["C=80 Np=512"])
    if args.phase == "kernels":
        log("[done] kernel phase only: no device line")
        return

    # every driven path zeroes the counters just before and reads them just
    # after; the JSON line sums the paths
    launches = {k: 0 for k in COUNTERS}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    def fpn_phase():
        fpn_launches, fpn_ms = run_fpn(torch, dev, card)
        add(fpn_launches)
        log("[e2e] FPN ms/image of the default request: " + ", ".join(
            f"{k} {v:.3f}" for k, v in fpn_ms.items()) + f" on {card}")
        for family in ("fpn", "fpn_relation", "fpn_learn_nms"):
            torch.cuda.empty_cache()
            counts, ms, peak = run_training(torch, dev, card, family=family,
                                            dense_steps=4, fused_steps=0)
            add(counts)
            log(f"[e2e] {family} train step, B=2: {ms:.3f} ms/step, peak "
                f"memory {peak:.3f} GiB on {card}")
    if args.phase == "fpn":
        fpn_phase()
        log(f"[done] FPN phases only: launches {launches}; no device line")
        return
    if args.phase == "workflow":
        add(run_workflow(torch, dev, card))
        log(f"[done] workflow phase only: launches {launches}; no device line")
        return
    if args.phase == "eval":
        add(run_eval(torch, dev, card))
        log(f"[done] eval phase only: launches {launches}; no device line")
        return

    def dp_phase():
        add(run_dp(torch, dev, card))
        torch.cuda.empty_cache()

    def reference_phase():
        counts, ms_image = run_reference(torch, dev, card)
        add(counts)
        log(f"[e2e] parity-mode (roi_method pool) pred_eval ms/image "
            f"{ms_image:.3f} on {card}")
        torch.cuda.empty_cache()
    if args.phase in ("dp", "reference"):
        (dp_phase if args.phase == "dp" else reference_phase)()
        log(f"[done] {args.phase} phase only: launches {launches}; no device "
            "line")
        return

    def cuts_phase():
        add(run_gate(torch, dev, card))
        torch.cuda.empty_cache()
        add(run_cuts(torch, dev, card))
        torch.cuda.empty_cache()
    if args.phase == "cuts":
        cuts_phase()
        log(f"[done] cuts phase only: launches {launches}; no device line")
        return
    if args.phase == "all":
        flagship_launches, ms_image = run_flagship(torch, dev)
        add(flagship_launches)
        log(f"[e2e] flagship median ms/image {ms_image:.3f} on {card}")
        add(run_training(torch, dev, card)[0])
        torch.cuda.empty_cache()
    if args.phase in ("all", "trunk"):
        fused_launches, fused_ms, model = run_fused_flagship(torch, dev, card)
        add(fused_launches)
        log(f"[e2e] flagship with FUSE_RES4 median ms/image {fused_ms:.3f} on {card}")
        add(run_fused_trunk(torch, dev, model, card))
        del model
        torch.cuda.empty_cache()
    if args.phase == "trunk":
        log(f"[done] trunk phases only: launches {launches}; no device line")
        return
    dcn_launches, dcn_ms = run_dcn_inference(torch, dev, card)
    add(dcn_launches)
    log(f"[e2e] dcn_learn_nms median ms/image {dcn_ms:.3f} on {card}")
    torch.cuda.empty_cache()
    add(run_training(torch, dev, card, family="dcn_learn_nms", dense_steps=3,
                     fused_steps=0)[0])
    if args.phase == "dcn":
        log(f"[done] DCN phases only: launches {launches}; no device line")
        return
    torch.cuda.empty_cache()
    fpn_phase()
    torch.cuda.empty_cache()
    add(run_workflow(torch, dev, card))
    torch.cuda.empty_cache()
    add(run_eval(torch, dev, card))
    torch.cuda.empty_cache()
    dp_phase()
    reference_phase()
    cuts_phase()
    for name in SHAPES:
        split = {k.split("@", 1)[1]: v for k, v in launches.items()
                 if k.startswith(name + "@")}
        log(f"[shapes] {name}: {launches[name]} launches; by shape {split}")
    never = [k for k, v in launches.items() if v <= 0]
    if never:
        fail(f"kernels never launched on any driven path: {never}")
    kernels = []
    for name, (source, replaces, _, _) in checks.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
