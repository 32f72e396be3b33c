"""Driver of a training cell: the port's RCNN step on cached proposals
(core/rpn_workflow.py::make_train_step_rcnn, mix kind "train_rcnn"), one
step after another.

Set-up builds the model, loads the seeded weights, and drives the one train
step object from the seed through its first ``check_steps`` steps on
distinct batches; those steps warm every shape and are the ones the
reference follows. The same object then runs the window over the rest of
the batch pool, cycled. The harness's copy of the weights leaves the device
before the window, so that the window's memory peak is the program's; the
check makes them again from the seed.
"""

from __future__ import annotations

import gc
import sys
import time

import torch

from benchmark.harness import flops, trace, traffic
from benchmark.harness.common import build_kernels, program_cfg
from benchmark.harness.weights import make_weights
from benchmark.reference import detector as ref


def build(ctx):
    from relation_tpu_torch.core.rpn_workflow import make_train_step_rcnn
    from relation_tpu_torch.core.trainer import build_model, create_train_state
    cj, mix, dev = ctx["config"], ctx["mix"], ctx["device"]
    cfg = program_cfg(cj, ctx["rehearse"])
    build_kernels(dev)
    W = make_weights(cj, ctx["seed"], dev)
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
    out = {"setup_s": setup_s, "images": steps * B, "window_s": wall,
           "peak_window": peak_window, "peak": max(peak_setup, peak_window),
           "attempted": steps, "failed": 0}
    if ctx["trace"]:
        spans = trace.install_spans(model)
        prof, twall, tsteps = trace.profile(window, float(mix["trace_seconds"]),
                                              ctx["device"].type == "cuda")
        trace.remove_spans(spans)
        rois = int(mix["rois_per_image"])
        R = rois + max(mix["gt_counts"])
        nongt = min(int(cj["train"]["rpn_post_nms_top_n"]), rois)
        out["trace"] = dict(trace.reduce(prof), window_s=twall, images=tsteps * B)
        out["flops_per_image"] = flops.train_flops(cj, rois, max(mix["gt_counts"]))
        out["attn_least_s"] = flops.attention_least_s(
            cj, R, nongt, int(cj["train"]["first_n"]))
        del prof
    del model, state, step, params
    gc.collect()
    if ctx["device"].type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = judge(ctx, batches[:n_check], losses, grad_norms,
                          change_norms)
    return out


def judge(ctx, batches, losses, grad_norms, change_norms) -> dict:
    """The reference follows the first steps from the weights made again
    from the seed. Numbers: the worst step's
    loss gap; the worst leaf's gap between the first gradients' norms; the
    median leaf's gap between the norms of the changes after the last step
    (the worst leaf's, which flips of the OHEM selection in the later steps
    move, is printed beside it). Leaves whose reference gradient is under
    a thousandth of the median leaf's are left out."""
    limits = ctx["config"]["limits"]["train"]
    W = make_weights(ctx["config"], ctx["seed"], ctx["device"])
    r_losses, r_first, r_final = ref.train_steps(W, ctx["config"], batches,
                                                 len(batches))
    skip, r_grad, _ = ref.nongrad_floor(r_first)
    r_change = {k: float((v - W[k]).norm()) for k, v in r_final.items()}
    loss_gap = max(ref.math_rel(a, b) for a, b in zip(losses, r_losses))
    grad_gap, g_at = ref.worst_leaf_gap(grad_norms, r_grad, skip)
    change_worst, c_at = ref.worst_leaf_gap(change_norms, r_change, skip)
    change_med = ref.median_leaf_gap(change_norms, r_change, skip)
    print(f"train check: losses {losses!r} reference {r_losses!r}; worst "
          f"gradient leaf {g_at}; worst change leaf {c_at} {change_worst!r}; "
          f"{len(skip)} leaves without gradient", file=sys.stderr)
    return {"loss_gap": (loss_gap, limits["loss_gap"]),
            "grad_gap": (grad_gap, limits["grad_gap"]),
            "change_gap_med": (change_med, limits["change_gap_med"])}


def sync(ctx):
    if ctx["device"].type == "cuda":
        torch.cuda.synchronize()


def max_mem(ctx) -> int:
    return torch.cuda.max_memory_allocated() if ctx["device"].type == "cuda" else 0


def reset_mem(ctx) -> None:
    if ctx["device"].type == "cuda":
        torch.cuda.reset_peak_memory_stats()
