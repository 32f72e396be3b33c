"""The heads' ROIAlign without host reads, on the CPU:

- the plain pyramid ROIAlign (ops/kernels/roi_align.py::roi_align_levels,
  the CPU path of pool_pyramid and of the C4 head) against roi_align_mxu,
  the JAX package's formulation, applied level by level to the ROIs each
  level dispatches, values and gradient;
- the FPN RCNN step's ROI stage (the ``step.rois`` span of
  core/trainer.py::run_step) makes no host round trip: no read of a
  tensor's value and no tensor built from host data on a device, either
  of which is a blocking copy on the card; its losses and first gradients
  equal those of the step pooling with the per-level roi_align_mxu
  formulation (grouped by a host read of the level counts, as the port
  pooled before).

The CUDA kernel's own checks are in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import relation_tpu_torch.models.fpn as fpn
from relation_tpu_torch.ops.kernels.roi_align import (roi_align_levels,
                                                      roi_levels)
from relation_tpu_torch.ops.roi_pool import roi_align_mxu
from relation_tpu_torch.utils import trace

STRIDES = (4, 8, 16, 32)


def per_level_mxu(levels, scales, rois, pooled_size=7):
    """The per-level formulation: each level's ROIs (found by a host read)
    pooled by roi_align_mxu and put back in their order."""
    fid = roi_levels(rois, len(levels))
    out = None
    for i, (feat, scale) in enumerate(zip(levels, scales)):
        sel = torch.nonzero(fid == i).flatten()
        if len(sel) == 0:
            continue
        part = roi_align_mxu(feat, rois[sel], scale, pooled_size)
        if out is None:
            out = part.new_zeros((rois.shape[0],) + part.shape[1:])
        out = out.index_copy(0, sel, part)
    return out


def _rois(case, rng, size):
    """ROIs of one case on a size x size image, and the levels they must
    reach."""
    wh = np.array([[30, 40], [300, 280], [230, 200], [60, 80], [10, 14],
                   [600, 520], [120, 150], [20, 20], [480, 500], [150, 170]],
                  np.float32)
    if case == "empty_level":
        wh = wh[[0, 2, 4, 5, 6, 8]]      # no ROI at stride 16
    xy = rng.uniform(0, 60, (len(wh), 2)).astype(np.float32)
    rois = np.concatenate([xy, xy + wh - 1], 1)
    if case == "edges_and_padding":
        # flush with the map's far edges, past them, and zero-size padding
        rois = np.concatenate([rois, np.array(
            [[size - 40, size - 30, size - 1, size - 1],
             [size - 300, 0, size + 20, 250],
             [0, 0, 0, 0], [0, 0, 0, 0], [7, 9, 7, 9]], np.float32)])
    want = {"all_levels": {0, 1, 2, 3}, "empty_level": {0, 1, 3},
            "edges_and_padding": {0, 1, 2, 3}}[case]
    return torch.from_numpy(rois.clip(0, size - 1)), want


@pytest.mark.parametrize("case", ["all_levels", "empty_level",
                                  "edges_and_padding", "one_level"])
def test_plain_pyramid_roi_align_matches_roi_align_mxu(case):
    """Values within 1e-5 of the largest of the per-level roi_align_mxu
    formulation, and the gradient of a random cotangent with respect to
    every level within 1e-5 of its largest (the same sums in another
    order); a level no ROI reaches gets a zero gradient. ``one_level`` is
    the C4 head's single map at stride 16."""
    rng = np.random.RandomState(3)
    size, C = 512, 8
    strides = (16,) if case == "one_level" else STRIDES
    if case == "one_level":
        rois, want_levels = _rois("edges_and_padding", rng, size)
        want_levels = {0}
    else:
        rois, want_levels = _rois(case, rng, size)
    assert set(roi_levels(rois, len(strides)).tolist()) == want_levels
    maps = [rng.randn(size // s, size // s, C).astype(np.float32)
            for s in strides]
    scales = [1.0 / s for s in strides]
    cot = torch.from_numpy(rng.randn(len(rois), 7, 7, C).astype(np.float32))

    def run(fn):
        levels = [torch.from_numpy(m).requires_grad_(True) for m in maps]
        out = fn(levels, scales, rois)
        return out.detach(), torch.autograd.grad(out, levels, cot,
                                                 allow_unused=True)
    got, grads = run(roi_align_levels)
    want, want_grads = run(per_level_mxu)
    top = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * top
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        if i not in want_levels:
            assert w is None and not g.any()
            continue
        gtop = float(w.abs().max())
        assert gtop > 0
        assert float((g - w).abs().max()) <= 1e-5 * gtop, i


# --------------------------------------------------------------------------
# the RCNN step's ROI stage
# --------------------------------------------------------------------------

READS = {torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.__int__,
         torch.Tensor.__float__, torch.Tensor.__bool__}
BUILDS = {torch.tensor, torch.as_tensor}


class _HostRoundTrips(TorchFunctionMode):
    """Records, while ``open`` is true, every read of a tensor's value on
    the host and every tensor built from host data with a device named."""

    def __init__(self):
        super().__init__()
        self.open, self.seen = False, []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.open and (func in READS or (
                func in BUILDS and not isinstance(args[0], torch.Tensor)
                and kwargs.get("device") is not None)):
            self.seen.append(getattr(func, "__name__", str(func)))
        return func(*args, **kwargs)


def _rcnn_step(monkeypatch, pool=None, recorder=None):
    """One RCNN step of the tiny fpn_learn_nms model (B=2, 160 cached ROIs
    an image over all four levels, three of them padding): (metrics, first
    gradients by leaf). ``pool`` replaces the pyramid ROIAlign."""
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.rpn_workflow import make_train_step_rcnn
    from relation_tpu_torch.core.trainer import build_model, create_train_state
    from relation_tpu_torch.entry import family_cfg
    if pool is not None:
        monkeypatch.setattr(fpn, "roi_align_levels", pool)
    if recorder is not None:
        class span(trace.span):
            def __enter__(self):
                recorder.open |= self.name == "step.rois"
                return super().__enter__()

            def __exit__(self, *exc):
                if self.name == "step.rois":
                    recorder.open = False
                return super().__exit__(*exc)
        monkeypatch.setattr(trace, "span", span)
    cfg = family_cfg("fpn_learn_nms")
    model = build_model(cfg, tiny=True, device="cpu")
    init_params(model, 0)
    state = create_train_state(model, cfg)
    rng = np.random.RandomState(0)
    B, R, G, size = 2, 160, 3, 512
    xy = rng.uniform(0, 200, (B, R, 2))
    wh = np.exp(rng.uniform(np.log(8.0), np.log(600.0), (B, R, 2)))
    rois = np.concatenate([xy, xy + wh], -1).clip(0, size - 1)
    gt = np.zeros((B, G, 5), np.float32)
    gt[:, :, :4] = [[30, 50, 240, 320], [160, 80, 480, 400], [64, 240, 320, 500]]
    gt[:, :, 4] = [1, 2, 3]
    rois[:, :G] = gt[:, :, :4] + rng.uniform(-8, 8, (B, G, 4))
    rois[:, G:G + 2] = [[0, 0, 511, 511], [10, 20, 500, 490]]   # stride 32
    valid = np.arange(R)[None].repeat(B, 0) < R - 3
    batch = dict(image=(rng.randn(B, size, size, 3) * 40).astype(np.float32),
                 im_info=np.array([[size, size, 1.0]] * B, np.float32),
                 gt_boxes=gt, gt_valid=np.ones((B, G), bool),
                 rois=rois.astype(np.float32), rois_valid=valid)
    assert len(set(roi_levels(torch.from_numpy(batch["rois"][0]),
                              4).tolist())) == 4
    grads, update = {}, state.tx.update

    def keep_grads(model, trace_, count):
        grads.update({k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None})
        return update(model, trace_, count)
    state.tx.update = keep_grads
    step = make_train_step_rcnn(model, cfg, max_rois=R, max_gt=G, device="cpu")
    if recorder is None:
        _, metrics = step(state, batch)
    else:
        with recorder:
            _, metrics = step(state, batch)
    return {k: float(v) for k, v in metrics.items()}, grads


def test_rcnn_step_rois_stage_makes_no_host_round_trip(monkeypatch):
    """While ``step.rois`` is open no tensor's value is read on the host
    (item, tolist, int, float, bool) and no tensor is built from host data
    on a device. The losses and the first gradients equal those of the
    per-level roi_align_mxu formulation within 1e-6 relative (a leaf's
    gradient by its norm; they read equal and below 7e-7 here)."""
    rec = _HostRoundTrips()
    metrics, grads = _rcnn_step(monkeypatch, recorder=rec)
    assert rec.seen == []
    want_m, want_g = _rcnn_step(monkeypatch, pool=per_level_mxu)
    assert {"nms_pos_loss", "rcnn_cls_loss"} <= set(metrics)
    assert set(metrics) == set(want_m)
    for k, w in want_m.items():
        assert metrics[k] == pytest.approx(w, rel=1e-6, abs=1e-12), k
    assert set(grads) == set(want_g) and len(grads) > 10
    # the key biases' gradient is zero in exact arithmetic (the softmax
    # cancels them), rounding noise near 1e-14 here: a floor of 1e-9 of the
    # whole gradient's norm, far below any other leaf's
    floor = 1e-9 * float(torch.stack([w.norm() for w in want_g.values()]).norm())
    for k, w in want_g.items():
        assert float((grads[k] - w).norm()) <= 1e-6 * float(w.norm()) + floor, k
