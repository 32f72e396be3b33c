"""Driver of mix kind "train_e2e": the port's END2END train step
(core/trainer.py::make_train_step), one step after another: trunk, RPN and
its anchor targets, the training proposals, every proposal and
ground-truth box through the head, OHEM, the learned-NMS branch, the
backward and the update.

Set-up builds the model, loads the seeded weights, and drives the one train
step object from the seed through its first ``check_steps`` steps on
distinct batches; those steps warm every shape and are the ones the
reference follows. The anchors' sampling priorities of every image are
drawn from the seed and handed to the program and to the reference alike.
The same object then runs the window over the rest of the batch pool,
cycled. The check judges the program's proposals of the first step against
the reference's own, then has the reference follow the check steps on the
program's proposals: a flip of one NMS decision between two near-equal
RPN scores changes a ROI and every later number, and is no fault.
"""

from __future__ import annotations

import gc
import sys
import time

import torch

from benchmark.harness import compare, flops, stages, trace, traffic
from benchmark.harness.common import (build_kernels, max_mem, program_cfg,
                                      program_registry, reset_mem,
                                      setup_snapshot, sync)
from benchmark.harness.weights import make_weights

KIND = "train"             # the suffix of the per-layer metrics it reports
INPUTS = ("image", "im_info", "gt_boxes", "gt_valid")
MATCH_IOU = 0.99           # a proposal matches a reference proposal at this IoU


def feature_size(config) -> tuple:
    """(h, w) of the C4 map of the configuration's bucket: four halvings,
    each rounded up (conv1, the max pool, res3a, res4a)."""
    out = []
    for n in config["images"]["bucket"]:
        for _ in range(4):
            n = (n + 1) // 2
        out.append(n)
    return tuple(out)


def build(ctx):
    from relation_tpu_torch.core.trainer import (build_model, create_train_state,
                                                 make_train_step)
    cj, mix, dev, seed = ctx["config"], ctx["mix"], ctx["device"], ctx["seed"]
    cfg = program_cfg(cj, ctx["rehearse"])
    build_kernels(dev)
    W = make_weights(ctx["reference"], cj, seed, dev)
    model = build_model(cfg, device=dev)
    model.load_state_dict(W, strict=True)
    state = create_train_state(model, cfg, seed=seed)
    B = int(mix["batch_images"])
    whole = make_train_step(model, cfg, no_grad=ctx["fault"] == "frozen_state",
                            device=dev)
    keep = B // 2 if ctx["fault"] == "half_batch" else B

    def step(st, batch):
        prio = [{"anchor": (batch["anchor_fg"][i], batch["anchor_bg"][i])}
                for i in range(keep)]
        return whole(st, {k: batch[k][:keep] for k in INPUTS}, prio)
    n = B * int(mix["pool_batches"])
    data = traffic.detection_batch(cj, dict(mix, rois_per_image=0,
                                            fg_roi_share=0.0), n, B, seed, dev)
    del data["rois"], data["rois_valid"]
    h, w = feature_size(cj)
    K = h * w * int(cj["arch"]["num_anchors"])
    g = torch.Generator(device=dev)
    g.manual_seed((int(seed) * 1_000_003 + 4) % (2 ** 63))
    u = torch.rand((2, n, K), generator=g, device=dev)
    data["anchor_fg"], data["anchor_bg"] = u[0], u[1]
    return model, state, step, W, traffic.split(data, B)


def _recording_rois(model, nongt: int, into: list):
    """Wrap ``model.head`` on the instance so that each call puts the first
    ``nongt`` ROIs it pools (an image's proposals) into ``into``; returns
    the undo."""
    head = model.head

    def wrapped(feat, rois, *a, **k):
        into.append(rois[:nongt].detach().clone())
        return head(feat, rois, *a, **k)
    model.head = wrapped
    return lambda: delattr(model, "head")


def run(ctx, t_start: float) -> dict:
    cj, mix = ctx["config"], ctx["mix"]
    registry = program_registry(ctx)
    n_check = int(mix["check_steps"])
    model, state, step, W, batches = build(ctx)
    wd = float(cj["train"]["wd"])
    nongt = int(cj["train"]["rpn_post_nms_top_n"])
    losses, grad_norms, props = [], {}, []
    for i in range(n_check):
        got = []
        undo = _recording_rois(model, nongt, got)
        state, m = step(state, batches[i])
        undo()
        props.append(got)
        losses.append(float(m["total_loss"]))
        if i == 0:
            grad_norms = {k: float((t - wd * W[k]).norm())
                          for k, t in state.trace.items()}
    params = dict(model.named_parameters())
    change_norms = {k: float((params[k].detach() - W[k]).norm())
                    for k in state.trace}
    del W
    sync(ctx)
    setup_s = time.perf_counter() - t_start
    peak_setup = max_mem(ctx)
    program_setup = setup_snapshot(registry)
    reset_mem(ctx)
    B = batches[0]["image"].shape[0]
    counter = [n_check]

    def window(deadline):
        n = 0
        while time.perf_counter() < deadline:
            step(state, batches[counter[0] % len(batches)])
            counter[0] += 1
            n += 1
        return n

    t0 = time.perf_counter()
    steps = window(t0 + ctx["seconds"])
    sync(ctx)
    wall = time.perf_counter() - t0
    peak_window = max_mem(ctx)
    out = {"kind": KIND, "setup_s": setup_s, "images": steps * B,
           "window_s": wall, "peak_window": peak_window,
           "peak": max(peak_setup, peak_window), "attempted": steps, "failed": 0}
    if ctx["trace"]:
        out["program_setup"] = program_setup
        spans = trace.install_spans(model)
        prof, twall, tsteps = trace.profile(window, float(mix["trace_seconds"]),
                                              ctx["device"].type == "cuda")
        trace.remove_spans(spans)
        out["trace"] = dict(trace.reduce(prof), window_s=twall, images=tsteps * B)
        del prof
        out["trace"]["stages"], out["program"] = stages.window(
            registry, window, float(mix["trace_seconds"]),
            ctx["device"].type == "cuda", lambda n: n * B)
        out["flops_per_image"], out["attn_least_s"] = work_counts(
            ctx["reference"], cj, mix)
        rois = nongt + max(mix["gt_counts"])
        out["dcn_least_s"] = dcn_least_s(cj, rois)
        out["col2im_least_s"] = col2im_least_s(cj)
    del model, state, step, params
    gc.collect()
    if ctx["device"].type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = judge(ctx, batches[:n_check], props, losses, grad_norms,
                          change_norms)
    return out


def work_counts(ref, config, mix):
    """(operations, least attention seconds) of one image of the step: the
    ``rpn_post_nms_top_n`` proposals and the mix's most ground-truth boxes
    through the head, the learned-NMS branch over the proposals."""
    nongt, gt = int(config["train"]["rpn_post_nms_top_n"]), max(mix["gt_counts"])
    return (ref.train_flops(config, nongt, gt),
            flops.attention_least_s(config, nongt + gt, nongt,
                                    int(config["train"]["first_n"])))


def _least(ops: float, nbytes: float, peak: float) -> float:
    return max(ops / peak, nbytes / flops.HBM_BYTES_S)


def dcn_least_s(config, rois: int) -> float:
    """Least time of one image's deformable forward, the work under the
    program's ``dcn.conv`` and ``dcn.pool`` spans. Each res5 unit: the
    offset conv's and the deformable conv's products at PEAK_TF32, or the
    map, the offsets, the output and both weights moved once (f32). Each of
    the two pools: its samples' four-corner multiply-adds over 256 channels
    at PEAK_F32, or the map, the ROIs (and the moves) and the output moved
    once. The ``offset`` FC between them: its products at PEAK_TF32, or its
    input, weight and output moved once."""
    h, w = feature_size(config)
    hw, C, off, taps = h * w, 512, 72, 9
    conv = _least(2 * hw * taps * C * (C + off),
                  4 * (hw * C + hw * off + hw * C + taps * C * (C + off)),
                  flops.PEAK_TF32)
    bins, samples, ch = 49, 16, 256
    pools = sum(_least(2 * rois * bins * samples * 4 * ch,
                       4 * (hw * ch + rois * 4 + moves + rois * bins * ch),
                       flops.PEAK_F32)
                for moves in (0, rois * 2 * bins))
    fc = _least(2 * rois * bins * ch * 2 * bins,
                4 * (rois * bins * ch + bins * ch * 2 * bins + rois * 2 * bins),
                flops.PEAK_TF32)
    return 3 * conv + pools + fc


def col2im_least_s(config) -> float:
    """Least time of one image's col2im (the deformable conv's dx), three
    res5 units: the column gradient (taps x channels a position, f32) read
    once and dx written once at HBM_BYTES_S, or the multiply-adds of every
    sample's four corners over its group's channels at PEAK_F32."""
    h, w = feature_size(config)
    hw, C, taps = h * w, 512, 9
    return 3 * _least(2 * hw * taps * 4 * C, 4 * (hw * taps * C + hw * C),
                      flops.PEAK_F32)


def _unmatched(prog, ref) -> int:
    """The proposals of ``prog`` [N, 4] with no box of ``ref`` at IoU
    MATCH_IOU or more."""
    return int((compare._iou(prog, ref).max(dim=1).values < MATCH_IOU).sum())


def judge(ctx, batches, props, losses, grad_norms, change_norms) -> dict:
    """Numbers: the share of the program's first-step proposals with no
    reference proposal at IoU 0.99 (an image the program did not run counts
    whole); then, the reference following the check steps on the program's
    proposals from the weights made again from the seed, the worst step's
    relative loss gap, the median leaf's gap between the first gradients'
    norms and the median leaf's gap between the norms of the changes after
    the last step. The worst leaf's gaps are printed beside them. Leaves
    whose reference gradient is under a thousandth of the median leaf's are
    left out."""
    limits = ctx["config"]["limits"]["train"]
    ref = ctx["reference"]
    W = make_weights(ref, ctx["config"], ctx["seed"], ctx["device"])
    B = batches[0]["image"].shape[0]
    own = ref.first_proposals(W, ctx["config"], batches[0])
    nongt = own.shape[1]
    missing = sum(_unmatched(p, o) for p, o in zip(props[0], own))
    prop_share = (missing + (B - len(props[0])) * nongt) / (B * nongt)
    follow = [dict(b, proposals=torch.stack(p)) if len(p) == B else b
              for b, p in zip(batches, props)]
    r_losses, r_first, r_final = ref.train_steps(W, ctx["config"], follow,
                                                 len(follow))
    skip, r_grad, _ = compare.nongrad_floor(r_first)
    r_change = {k: float((v - W[k]).norm()) for k, v in r_final.items()}
    loss_gap = max(compare.math_rel(a, b) for a, b in zip(losses, r_losses))
    grad_med = compare.median_leaf_gap(grad_norms, r_grad, skip)
    grad_worst, g_at = compare.worst_leaf_gap(grad_norms, r_grad, skip)
    change_med = compare.median_leaf_gap(change_norms, r_change, skip)
    change_worst, c_at = compare.worst_leaf_gap(change_norms, r_change, skip)
    print(f"train check: losses {losses!r} reference {r_losses!r}; "
          f"{missing} of {len(props[0]) * nongt} first-step proposals "
          f"unmatched; worst gradient leaf {g_at} {grad_worst!r}; worst change "
          f"leaf {c_at} {change_worst!r}; {len(skip)} leaves without gradient",
          file=sys.stderr)
    return {"prop_unmatched_share": (prop_share, limits["prop_unmatched_share"]),
            "loss_gap": (loss_gap, limits["loss_gap"]),
            "grad_gap_med": (grad_med, limits["grad_gap_med"]),
            "change_gap_med": (change_med, limits["change_gap_med"])}
