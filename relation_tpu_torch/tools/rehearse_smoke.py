"""Rehearse chip_smoke.py's end-to-end phases on the CPU, at the tiny size.

    python3 -m relation_tpu_torch.tools.rehearse_smoke [--phase workflow|eval|dp|reference|cuts]

A CUDA kernel cannot run without a card, so this is no check of the kernels:
it finds wrong paths, arguments, shapes and control flow in chip_smoke.py
and in the glue around the kernels before a run on the card is spent on
them. It stubs the few torch.cuda calls the script makes, puts the plain
version behind every kernel launcher, routes the model's kernel calls
through the same autograd.Functions and launch counters the card uses, and
then calls ``run_flagship``, ``run_training``, ``run_dcn_inference`` and the
DCN ``run_training`` with ``tiny=True`` (tiny trunk, 64x128 image; the tiny
trunk has no res5, so the DCN rehearsal covers the deformable PSROI head, the
classic NMS tail and the offset seeding, not the deformable conv), then
``run_fused_flagship``, ``run_fused_trunk`` and ``run_fpn`` (the full-depth
trunk and FPN models, as entry() builds them, on a 64x128 image), then the
FPN ``run_training`` of the three families with ``tiny=True``, then
``run_workflow`` (phase 12; ``--phase workflow`` rehearses it alone), then
``run_eval`` (phase 13: the drivers on a mini dataset of 48x64 and 64x48
images; ``--phase eval`` rehearses it alone, ``--no-pil`` takes its route
for a machine without PIL), then ``run_dp`` (phase 14: two gloo ranks
spawned on the CPU, where they run the plain versions; ``--phase dp``) and
``run_reference`` (phase 15 with the tiny trunk; ``--phase reference``),
then ``run_gate`` and ``run_cuts`` (phase 16 with the tiny trunk on 64x128
images: the gate's two requests, f32 and bf16 trunk, without its golden,
which is for 608x1024, and every cut of both steps; ``--phase cuts``). It prints what the script
prints; its times are CPU times and mean nothing.
"""

from __future__ import annotations

import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))


def install_stubs() -> None:
    import relation_tpu_torch.models.backbone as bb
    import relation_tpu_torch.models.detector as det
    import relation_tpu_torch.models.fpn as fpn
    import relation_tpu_torch.models.relation as rel
    import relation_tpu_torch.ops.deform as deform
    import relation_tpu_torch.ops.nms as nms
    import chip_smoke
    from relation_tpu_torch.ops.kernels import (bias_attention, bottleneck_proj,
                                                dconv_col2im, geom_bias,
                                                nms_attention, nms_kernel, res4,
                                                roi_align, roi_pool, stem)
    torch.cuda.synchronize = lambda *a, **k: None
    chip_smoke.time_ms = lambda torch, fn, **k: (fn(), 0.0)[1]
    torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.empty_cache = lambda *a, **k: None

    # plain versions behind the launchers
    geom_bias._launch = lambda p, k, b, s, raw=False: (
        geom_bias.geom_acc_reference(p, k, b, s) if raw
        else geom_bias.geom_bias_reference(p, k, b, s))

    def launch_bwd(p, k, b, g, s, need_pos=True, want_acc=False):
        d_pos, d_w, d_b = geom_bias.geom_bias_bwd_reference(p, k, b, g, s)
        return (d_pos if need_pos else None, d_w, d_b)
    geom_bias._launch_bwd = launch_bwd
    nms_attention._launch = lambda pos, q, k, v, wg, bg, wl, active, s, name: (
        nms_attention.nms_relation_attention_reference(pos, q, k, v, wg, bg,
                                                       wl, active, s))
    bias_attention._launch = lambda bias, q, k, v, wl, active, name: (
        bias_attention.bias_attention_reference(bias, q, k, v, wl, active))
    stem.stem_weight_fragments = lambda w4: w4
    stem._launch = stem.stem_reference
    res4._launch = res4.bottleneck_stack_reference

    def pool_launch(feat, rois, scale, P, with_argmax=True):
        am = roi_pool.roi_pool_argmax_reference(feat, rois, scale, P)
        return (roi_pool._pool_at(feat.detach(), am),
                am.to(torch.int32) if with_argmax else None)

    def pool_launch_bwd(dout, argmax, H, W):
        C = dout.shape[-1]
        d = torch.zeros(H * W * C, dtype=torch.float32)
        idx = (argmax.long().clamp(min=0) * C + torch.arange(C)).reshape(-1)
        d.index_add_(0, idx, (dout.float() * (argmax >= 0)).reshape(-1))
        return d.reshape(H, W, C)
    roi_pool._launch, roi_pool._launch_bwd = pool_launch, pool_launch_bwd

    def align_launch(levels, scales, rois, P, S):
        with torch.no_grad():
            return roi_align.roi_align_levels_reference(levels, scales, rois, P, S)

    def align_launch_bwd(dout, rois, shapes, scales, P, S, wanted):
        # ROIAlign is linear in the maps: the gradient needs no values
        lv = [torch.zeros(s, requires_grad=True) for s in shapes]
        with torch.enable_grad():
            out = roi_align.roi_align_levels_reference(lv, scales, rois, P, S)
            grads = torch.autograd.grad(out, lv, dout.float())
        return [g if w else None for g, w in zip(grads, wanted)]
    roi_align._launch, roi_align._launch_bwd = align_launch, align_launch_bwd

    # the model's calls, through the Functions and counters of the card path
    def counted(mod, attr, fn):
        def call(*a, **k):
            setattr(mod, attr, getattr(mod, attr) + 1)
            return fn(*a, **k)
        return call
    rel.fused_geometric_bias = lambda p, k, b, scale=100.0: (
        geom_bias._GeomBias.apply(p, k, b, float(scale)))
    rel.fused_nms_relation_attention = lambda *a, scale=100.0: (
        nms_attention._FullAttention.apply(*a, float(scale)))
    rel.fused_nms_relation_attention_skip = counted(
        nms_attention, "launches",
        nms_attention.nms_relation_attention_reference)
    rel.fused_geometric_bias_skip = counted(geom_bias, "skip_launches",
                                            geom_bias.geom_bias_skip_reference)
    rel.fused_bias_attention = bias_attention._BiasAttention.apply
    rel.fused_bias_attention_skip = counted(
        bias_attention, "skip_launches", bias_attention.bias_attention_reference)
    bb.stem_conv1_bn_relu = stem._Stem.apply
    det.roi_pool = fpn.roi_pool = lambda f, r, s, P=7: roi_pool._pool_kernels(
        f.contiguous(), r.detach().float().contiguous(), float(s), int(P))
    det.roi_align_levels = fpn.roi_align_levels = (
        lambda levels, scales, r, P=7, S=2: roi_align._RoiAlign.apply(
            r.detach().float().contiguous(), tuple(float(x) for x in scales),
            int(P), int(S), *[f.contiguous() for f in levels]))
    def nms_keep(bT, *a, **k):
        from relation_tpu_torch.ops.kernels import _build
        _build.count(vars(nms_kernel), "launches", "launch_shapes",
                     f"C={bT.shape[0]} Np={bT.shape[2]}")
        return nms_kernel.nms_keep_sorted_reference(bT, *a, **k)
    nms.nms_keep_sorted = nms_keep
    deform.dconv_col2im = counted(dconv_col2im, "launches",
                                  dconv_col2im.dconv_col2im_reference)
    bb.fused_bottleneck_stack = res4._Stack.apply
    bb.fused_proj_bottleneck = counted(bottleneck_proj, "launches",
                                       bottleneck_proj.proj_bottleneck_reference)


def main() -> None:
    import argparse
    import chip_smoke
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=["all", "workflow", "eval", "dp",
                                        "reference", "cuts"],
                    default="all")
    ap.add_argument("--no-pil", action="store_true",
                    help="phase 13 as on a machine without PIL")
    args = ap.parse_args()
    install_stubs()
    cpu = torch.device("cpu")
    card = "the CPU (rehearsal)"
    if args.phase == "workflow":
        chip_smoke.run_workflow(torch, cpu, card=card, tiny=True)
        print("rehearsal done: control flow only, no kernel ran")
        return
    if args.phase == "eval":
        chip_smoke.run_eval(torch, cpu, card=card, tiny=True,
                            use_pil=False if args.no_pil else None)
        print("rehearsal done: control flow only, no kernel ran")
        return
    if args.phase == "dp":
        chip_smoke.run_dp(torch, cpu, card=card, tiny=True)
        print("rehearsal done: control flow only, no kernel ran")
        return
    if args.phase == "reference":
        chip_smoke.run_reference(torch, cpu, card=card, tiny=True)
        print("rehearsal done: control flow only, no kernel ran")
        return
    if args.phase == "cuts":
        chip_smoke.run_gate(torch, cpu, card=card, tiny=True)
        chip_smoke.run_cuts(torch, cpu, card=card, tiny=True)
        print("rehearsal done: control flow only, no kernel ran")
        return
    chip_smoke.run_flagship(torch, cpu, tiny=True)
    chip_smoke.run_training(torch, cpu, card=card, tiny=True)
    chip_smoke.run_dcn_inference(torch, cpu, card=card, tiny=True)
    chip_smoke.run_training(torch, cpu, card=card, tiny=True,
                            family="dcn_learn_nms", dense_steps=3, fused_steps=0)
    _, _, model = chip_smoke.run_fused_flagship(torch, cpu, card=card, tiny=True)
    chip_smoke.run_fused_trunk(torch, cpu, model, card=card, tiny=True)
    del model
    chip_smoke.run_fpn(torch, cpu, card=card, tiny=True)
    for family in ("fpn", "fpn_relation", "fpn_learn_nms"):
        chip_smoke.run_training(torch, cpu, card=card, tiny=True, family=family,
                                dense_steps=4, fused_steps=0)
    chip_smoke.run_workflow(torch, cpu, card=card, tiny=True)
    chip_smoke.run_eval(torch, cpu, card=card, tiny=True,
                        use_pil=False if args.no_pil else None)
    chip_smoke.run_dp(torch, cpu, card=card, tiny=True)
    chip_smoke.run_reference(torch, cpu, card=card, tiny=True)
    chip_smoke.run_gate(torch, cpu, card=card, tiny=True)
    chip_smoke.run_cuts(torch, cpu, card=card, tiny=True)
    print("rehearsal done: control flow only, no kernel ran")


if __name__ == "__main__":
    main()
