"""Driver of mix kind "train_rcnn": the port's RCNN step on cached
proposals (core/rpn_workflow.py::make_train_step_rcnn), one step after
another.

Set-up builds the model, loads the seeded weights, and drives the one train
step object from the seed through its first ``check_steps`` steps on
distinct batches; those steps warm every shape and are the ones the
reference follows. The same object then runs the window over the rest of
the batch pool, cycled. The harness's copy of the weights leaves the device
before the window, so that the window's memory peak is the program's; the
check makes them again from the seed, and the configuration's reference
follows the first steps from them.
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


def build(ctx):
    from relation_tpu_torch.core.rpn_workflow import make_train_step_rcnn
    from relation_tpu_torch.core.trainer import build_model, create_train_state
    cj, mix, dev = ctx["config"], ctx["mix"], ctx["device"]
    cfg = program_cfg(cj, ctx["rehearse"])
    build_kernels(dev)
    W = make_weights(ctx["reference"], cj, ctx["seed"], dev)
    model = build_model(cfg, device=dev)
    model.load_state_dict(W, strict=True)
    state = create_train_state(model, cfg, seed=ctx["seed"])
    B = int(mix["batch_images"])
    G = max(mix["gt_counts"])
    frozen = ctx["fault"] == "frozen_state"
    whole = make_train_step_rcnn(model, cfg, max_rois=int(mix["rois_per_image"]),
                                 max_gt=G, no_grad=frozen, device=dev)
    keep = B // 2 if ctx["fault"] == "half_batch" else B

    def step(st, batch):
        return whole(st, {k: v[:keep] for k, v in batch.items()}, None)
    data = traffic.detection_batch(cj, mix, B * int(mix["pool_batches"]), B,
                                   ctx["seed"], dev)
    return model, state, step, W, traffic.split(data, B)


def run(ctx, t_start: float) -> dict:
    cj, mix = ctx["config"], ctx["mix"]
    registry = program_registry(ctx)
    n_check = int(mix["check_steps"])
    model, state, step, W, batches = build(ctx)
    wd = float(cj["train"]["wd"])
    losses, grad_norms = [], {}
    for i in range(n_check):
        state, m = step(state, batches[i])
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
    del model, state, step, params
    gc.collect()
    if ctx["device"].type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = judge(ctx, batches[:n_check], losses, grad_norms,
                          change_norms)
    return out


def work_counts(ref, config, mix):
    """(operations, least attention seconds) of one image of the step: the
    mix's ROIs and its most ground truth boxes, the learned-NMS branch over
    the first ``rpn_post_nms_top_n`` ROIs."""
    rois, gt = int(mix["rois_per_image"]), max(mix["gt_counts"])
    nongt = min(int(config["train"]["rpn_post_nms_top_n"]), rois)
    return (ref.train_flops(config, rois, gt),
            flops.attention_least_s(config, rois + gt, nongt,
                                    int(config["train"]["first_n"])))


def judge(ctx, batches, losses, grad_norms, change_norms) -> dict:
    """The reference follows the first steps from the weights made again
    from the seed. Numbers: the worst step's
    loss gap; the worst leaf's gap between the first gradients' norms; the
    median leaf's gap between the norms of the changes after the last step
    (the worst leaf's, which flips of the OHEM selection in the later steps
    move, is printed beside it). Leaves whose reference gradient is under
    a thousandth of the median leaf's are left out."""
    limits = ctx["config"]["limits"]["train"]
    ref = ctx["reference"]
    W = make_weights(ref, ctx["config"], ctx["seed"], ctx["device"])
    r_losses, r_first, r_final = ref.train_steps(W, ctx["config"], batches,
                                                 len(batches))
    skip, r_grad, _ = compare.nongrad_floor(r_first)
    r_change = {k: float((v - W[k]).norm()) for k, v in r_final.items()}
    loss_gap = max(compare.math_rel(a, b) for a, b in zip(losses, r_losses))
    grad_gap, g_at = compare.worst_leaf_gap(grad_norms, r_grad, skip)
    change_worst, c_at = compare.worst_leaf_gap(change_norms, r_change, skip)
    change_med = compare.median_leaf_gap(change_norms, r_change, skip)
    print(f"train check: losses {losses!r} reference {r_losses!r}; worst "
          f"gradient leaf {g_at}; worst change leaf {c_at} {change_worst!r}; "
          f"{len(skip)} leaves without gradient", file=sys.stderr)
    return {"loss_gap": (loss_gap, limits["loss_gap"]),
            "grad_gap": (grad_gap, limits["grad_gap"]),
            "change_gap_med": (change_med, limits["change_gap_med"])}

