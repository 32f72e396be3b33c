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
  pooled before);
- the whole train step, input stage to update, makes none either, for the
  FPN RCNN step and the deformable END2END step, and its losses and first
  gradients are bit-equal to those of the step fed the images it made
  image by image with host means (a frozen copy of that form here); the
  batched mean subtraction equals that form exactly; the update's two
  multi-tensor groups equal its per-leaf loop exactly.

The CUDA kernel's own checks, and two END2END steps under
``torch.cuda.set_sync_debug_mode("error")``, are in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import relation_tpu_torch.models.fpn as fpn
from relation_tpu_torch.ops.kernels.roi_align import (roi_align_levels,
                                                      roi_levels)
from relation_tpu_torch.ops.roi_pool import roi_align_mxu
from benchmark.harness.common import program_cfg
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


# --------------------------------------------------------------------------
# the whole step, and its input stage's mean subtraction
# --------------------------------------------------------------------------

def _frozen_image_from_u8(image, im_info, pixel_means):
    """core/predictor.py::_image_from_u8 as the step ran it image by image
    before its means became a device tensor: one image, the means a host
    tuple made into a tensor on the image's device."""
    if image.dtype != torch.uint8:
        return image
    dev = image.device
    means = torch.as_tensor(pixel_means, dtype=torch.float32, device=dev).reshape(-1)
    h, w = im_info[0], im_info[1]
    if image.dim() == 3 and image.shape[0] == 12 and image.shape[-1] != 3:
        k = torch.arange(12, device=dev)
        x = image.float() - means[k % 3][:, None, None]
        hh, ww = image.shape[1], image.shape[2]
        row_ok = (2.0 * torch.arange(hh, device=dev)[None, :] + (k // 6)[:, None]) < h
        col_ok = (2.0 * torch.arange(ww, device=dev)[None, :]
                  + ((k // 3) % 2)[:, None]) < w
        return x * (row_ok[:, :, None] & col_ok[:, None, :])
    x = image.float() - means[None, None, :]
    row_ok = torch.arange(image.shape[0], dtype=torch.float32,
                          device=dev)[:, None, None] < h
    col_ok = torch.arange(image.shape[1], dtype=torch.float32,
                          device=dev)[None, :, None] < w
    return x * (row_ok & col_ok)


def _frozen_input(batch, pixel_means):
    """The batch with its uint8 images replaced by the f32 images the step
    made of them before: image by image through the frozen function, the
    means a host tuple, stacked."""
    means = tuple(float(m) for m in pixel_means)
    info = torch.as_tensor(batch["im_info"]).float()
    image = torch.stack([_frozen_image_from_u8(batch["image"][b], info[b], means)
                         for b in range(len(info))])
    assert image.dtype == torch.float32
    return dict(batch, image=image)


MEANS = (103.06, 115.9, 123.15)


@pytest.mark.parametrize("info", ["full", "padded"])
@pytest.mark.parametrize("layout", ["s2d", "nhwc"])
def test_batched_mean_subtraction_is_bit_equal_to_the_per_image_form(layout,
                                                                     info):
    """_image_from_u8 over a batch, with the means a device tensor
    (pixel_means_tensor), and over each image as a batch of one (as the
    predict functions call it) equal the per-image form with host means
    exactly, pad re-zeroing included (odd heights and widths, so an s2d
    pixel pair straddles the edge)."""
    from relation_tpu_torch.core.predictor import (_image_from_u8,
                                                   pixel_means_tensor)
    from relation_tpu_torch.entry import family_cfg
    cfg = family_cfg("flagship")
    cfg.network.PIXEL_MEANS = np.array(MEANS)
    rng = np.random.RandomState(11)
    B, H, W = 3, 24, 40
    sizes = ([[H, W, 1.0]] * B if info == "full"
             else [[H, W, 1.0], [17, 31, 0.5], [9, 40, 2.0]])
    im_info = torch.tensor(sizes, dtype=torch.float32)
    if layout == "s2d":
        image = torch.from_numpy(rng.randint(0, 256, (B, 12, H // 2, W // 2),
                                             dtype=np.uint8))
    else:
        image = torch.from_numpy(rng.randint(0, 256, (B, H, W, 3),
                                             dtype=np.uint8))
    want = torch.stack([_frozen_image_from_u8(image[b], im_info[b], MEANS)
                        for b in range(B)])
    means = pixel_means_tensor(cfg, "cpu")
    got = _image_from_u8(image, im_info, means)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)
    for b in range(B):
        one = _image_from_u8(image[b][None], im_info[b][None], means)
        assert torch.equal(one[0], want[b])
    if info == "padded":
        assert bool((want == 0).any()) and not bool((want[0] == 0).all())
    f32 = want + 0.5
    assert _image_from_u8(f32, im_info, means) is f32


def _u8_rcnn_batch():
    """The tiny FPN RCNN step's batch of _rcnn_step as CPU tensors, its
    images uint8 NHWC, the second padded (im_info under the image's size)."""
    rng = np.random.RandomState(2)
    B, R, G, size = 2, 160, 3, 512
    xy = rng.uniform(0, 200, (B, R, 2))
    wh = np.exp(rng.uniform(np.log(8.0), np.log(400.0), (B, R, 2)))
    rois = np.concatenate([xy, xy + wh], -1).clip(0, 447)
    gt = np.zeros((B, G, 5), np.float32)
    gt[:, :, :4] = [[30, 50, 240, 320], [160, 80, 440, 400], [64, 240, 320, 440]]
    gt[:, :, 4] = [1, 2, 3]
    rois[:, :G] = gt[:, :, :4] + rng.uniform(-8, 8, (B, G, 4))
    batch = dict(image=rng.randint(0, 256, (B, size, size, 3), dtype=np.uint8),
                 im_info=np.array([[size, size, 1.0], [448, 480, 1.0]],
                                  np.float32),
                 gt_boxes=gt, gt_valid=np.ones((B, G), bool),
                 rois=rois.astype(np.float32),
                 rois_valid=np.arange(R)[None].repeat(B, 0) < R - 3)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _keep_grads(state, into):
    """Record the gradients the update sees, by leaf, into ``into``."""
    update = state.tx.update

    def keep(model, trace_, count):
        into.update({k: p.grad.clone() for k, p in model.named_parameters()
                     if p.grad is not None})
        return update(model, trace_, count)
    state.tx.update = keep


def _whole_rcnn_step(frozen: bool, recorder=None):
    """One step of the tiny fpn_learn_nms RCNN step on _u8_rcnn_batch:
    (metrics, first gradients). ``frozen`` hands it the images the step
    made before (_frozen_input)."""
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.rpn_workflow import make_train_step_rcnn
    from relation_tpu_torch.core.trainer import build_model, create_train_state
    from relation_tpu_torch.entry import family_cfg
    cfg = family_cfg("fpn_learn_nms")
    model = build_model(cfg, tiny=True, device="cpu")
    init_params(model, 0)
    state = create_train_state(model, cfg, seed=3)
    grads = {}
    _keep_grads(state, grads)
    batch = _u8_rcnn_batch()
    if frozen:
        batch = _frozen_input(batch, cfg.network.PIXEL_MEANS)
    step = make_train_step_rcnn(model, cfg, max_rois=160, max_gt=3,
                                device="cpu")
    return _run_recorded(step, state, batch, recorder), grads


def _whole_end2end_step(frozen: bool, recorder=None):
    """One END2END step of the dcn_learn_nms model and batch as
    test_torch_dcn_reference.py builds them (the benchmark cell at its CPU
    rehearsal size, seed 5: uint8 s2d images, the second padded, anchor
    priorities from the seed): (metrics, first gradients)."""
    from benchmark.harness import cells
    from benchmark.harness.common import rehearsal
    from benchmark.reference import dcn as ref
    spec = cells.resolve("dcn_learn_nms.train_b4")
    config, mix = rehearsal(spec["config"], spec["mix"])
    ctx = {"config": config, "reference": ref, "mix": mix, "seed": 5,
           "device": torch.device("cpu"), "rehearse": True, "fault": ""}
    model, state, step, _, batches = cells.driver(mix["kind"]).build(ctx)
    grads = {}
    _keep_grads(state, grads)
    batch = batches[0]
    assert batch["image"].dtype == torch.uint8 and batch["image"].dim() == 4
    if frozen:
        batch = _frozen_input(batch,
                              program_cfg(config, True).network.PIXEL_MEANS)
    return _run_recorded(step, state, batch, recorder), grads


def _run_recorded(step, state, batch, recorder):
    """The step's batch-mean metrics as floats, the whole call under
    ``recorder`` when one is given."""
    if recorder is None:
        _, metrics = step(state, batch)
    else:
        recorder.open = True
        with recorder:
            _, metrics = step(state, batch)
        recorder.open = False
    return {k: float(v) for k, v in metrics.items()}


@pytest.fixture
def deterministic():
    """PyTorch's deterministic algorithms for the test: on the CPU some of
    the step's scatter-adds sum in another order from run to run, which
    moves a few gradients by an ulp."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.mark.parametrize("kind", ["rcnn", "end2end"])
def test_whole_step_makes_no_host_round_trip(kind, deterministic, monkeypatch):
    """From its input stage to its update, a train step fed a batch already
    on its device reads no tensor's value on the host and builds no tensor
    from host data on a device (either is a blocking copy on the card, and
    the first of a step's waits for the previous step's backward). Its
    losses and first gradients are bit-equal to those of the step fed the
    images the step made before its means were a device tensor and its mean
    subtraction one batched call (_frozen_input), from the same weights and
    seed, both under deterministic algorithms: the FPN RCNN step (NHWC
    images) and the deformable END2END step (s2d images). The CPU's plain
    NMS, which the card does not run, is left out of the record."""
    from relation_tpu_torch.ops.kernels import nms_kernel
    run = {"rcnn": _whole_rcnn_step, "end2end": _whole_end2end_step}[kind]
    rec = _HostRoundTrips()
    # the proposals' NMS runs its plain version on the CPU, which reads the
    # host between blocks; the card runs row 4's kernel in its place, one
    # launch and no read (tests/test_torch_cuda.py holds it on the card)
    plain, calls = nms_kernel.nms_keep_sorted_reference, []

    def unrecorded(*args, **kwargs):
        calls.append(1)
        rec.open = False
        try:
            return plain(*args, **kwargs)
        finally:
            rec.open = True
    monkeypatch.setattr(nms_kernel, "nms_keep_sorted_reference", unrecorded)
    metrics, grads = run(False, rec)
    monkeypatch.undo()
    assert rec.seen == []
    assert len(calls) == (2 if kind == "end2end" else 0)
    want_m, want_g = run(True)
    assert metrics == want_m and "total_loss" in metrics
    assert set(grads) == set(want_g) and len(grads) > 10
    for k, w in want_g.items():
        assert torch.equal(grads[k], w), k


@pytest.mark.parametrize("clip", [0.0, 1e-3])
def test_update_in_two_groups_is_bit_equal_to_the_per_leaf_loop(clip):
    """Optimizer.update adds the momentum traces in two multi-tensor calls
    (the ``offset`` leaves at 0.01 of the rate, the rest at the rate) where
    it added them leaf by leaf when a model had offset leaves: parameters
    and traces come out bit-equal to the per-leaf loop's, over three
    updates, clipped and not (a leaf without a gradient still decays)."""
    from relation_tpu_torch.core.trainer import Optimizer

    def model():
        torch.manual_seed(0)
        m = torch.nn.ModuleDict({
            "conv": torch.nn.Linear(5, 4),
            "offset": torch.nn.Linear(4, 3),
            "head": torch.nn.ModuleDict({"offset": torch.nn.Linear(3, 2)}),
            "idle": torch.nn.Linear(2, 2)})
        return m
    names = [n for n, _ in model().named_parameters()]
    opt = Optimizer(schedule=lambda step: 0.02 / (1 + step), momentum=0.9,
                    wd=1e-4, clip=clip, mask={n: True for n in names})

    def frozen_update(m, trace_, step):
        """The per-leaf loop the update ran before."""
        names, params, grads = [], [], []
        for n, p in m.named_parameters():
            names.append(n)
            params.append(p)
            grads.append(torch.zeros_like(p) if p.grad is None else p.grad)
        if opt.clip > 0:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            scale = torch.where(norm < opt.clip, torch.ones_like(norm),
                                opt.clip / norm)
            grads = torch._foreach_mul(grads, scale)
        grads = torch._foreach_add(grads, params, alpha=opt.wd)
        traces = [trace_[n] for n in names]
        torch._foreach_mul_(traces, opt.momentum)
        torch._foreach_add_(traces, grads)
        lr = opt.schedule(step)
        slow = [i for i, n in enumerate(names) if "offset" in n.split(".")]
        for i, (p, t) in enumerate(zip(params, traces)):
            p.add_(t, alpha=-lr * (0.01 if i in slow else 1.0))

    runs = []
    for update in (opt.update, torch.no_grad()(frozen_update)):
        m = model()
        trace_ = opt.init(m)
        x = torch.randn(7, 5, generator=torch.Generator().manual_seed(1))
        for step in range(3):
            for p in m.parameters():
                p.grad = None
            m["head"]["offset"](m["offset"](m["conv"](x))).square().sum().backward()
            update(m, trace_, step)
        runs.append(({n: p.detach().clone() for n, p in m.named_parameters()},
                     trace_))
    (got, got_t), (want, want_t) = runs
    assert len(got) == 8 and sum("offset" in n for n in got) == 4
    for n in got:
        assert torch.equal(got[n], want[n]), n
        assert torch.equal(got_t[n], want_t[n]), n
    assert not torch.equal(got["idle.weight"], model()["idle"].weight)


@pytest.mark.parametrize("sampled", [False, True])
def test_step_draws_its_priorities_in_the_order_of_the_images(sampled):
    """An END2END step handed no priorities draws them from the state's
    generator before the images (so that every image's targets can
    replay), in the order the images drew them one after another: anchor
    (fg, bg), then in sampled mode the sampler's four vectors, image by
    image. Its metrics and the generator's state after it equal those of
    the step handed priorities drawn so from a generator of the same
    seed."""
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.trainer import (build_model, create_train_state,
                                                 make_train_step, rpn_rows_fn)
    from relation_tpu_torch.entry import family_cfg
    from relation_tpu_torch.models.targets import uniform_priorities
    cfg = family_cfg("flagship")
    if sampled:
        cfg.TRAIN.LEARN_NMS = False
        cfg.TRAIN.BATCH_ROIS = 16
        cfg.TRAIN.ENABLE_OHEM = False
    model = build_model(cfg, tiny=True, device="cpu")
    rng = np.random.RandomState(6)
    B, G, size = 2, 3, 64
    gt = np.zeros((B, G, 5), np.float32)
    gt[:, :2] = [[8, 10, 30, 34, 1], [24, 28, 52, 58, 2]]
    batch = dict(image=(rng.randn(B, size, size, 3) * 40).astype(np.float32),
                 im_info=np.array([[size, size, 1.0]] * B, np.float32),
                 gt_boxes=gt, gt_valid=np.arange(G)[None].repeat(B, 0) < 2)

    def run(priorities):
        init_params(model, seed=1)
        state = create_train_state(model, cfg, seed=9)
        _, m = make_train_step(model, cfg, device="cpu")(state, batch,
                                                          priorities)
        return ({k: float(v) for k, v in m.items()},
                state.generator.get_state())
    got, after = run(None)
    with torch.no_grad():
        _, rpn_cls, rpn_bbox = model.features_and_rpn(
            torch.from_numpy(batch["image"]))
    K = rpn_rows_fn(model, cfg, "cpu")((rpn_cls[0], rpn_bbox[0]))[0].shape[0]
    gen = torch.Generator().manual_seed(9)
    prio = []
    for _ in range(B):
        p = {"anchor": uniform_priorities(gen, 2, K, "cpu")}
        if sampled:
            p["sample"] = uniform_priorities(
                gen, 4, int(cfg.TRAIN.RPN_POST_NMS_TOP_N) + G, "cpu")
        prio.append(p)
    want, _ = run(prio)
    assert got == want and np.isfinite(got["total_loss"])
    assert torch.equal(after, gen.get_state())


@pytest.mark.parametrize("kind", ["rpn", "rcnn_take_all", "rcnn_sampled"])
def test_rpn_and_rcnn_steps_draw_their_priorities_in_the_order_of_the_images(
        kind, deterministic):
    """The alternate workflow's steps (core/rpn_workflow.py) handed no
    priorities draw them as the END2END step does: from the state's
    generator before the images, in the order the images drew them one
    after another (the RPN step: anchor (fg, bg); the RCNN step in sampled
    mode: the sampler's four vectors [R + G]; in take-all mode nothing).
    Metrics and the generator's state after the step equal those of the
    step handed priorities drawn so from a generator of the same seed."""
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.rpn_workflow import (make_train_step_rcnn,
                                                      make_train_step_rpn)
    from relation_tpu_torch.core.trainer import (build_model, create_train_state,
                                                 rpn_rows_fn)
    from relation_tpu_torch.entry import family_cfg
    from relation_tpu_torch.models.targets import uniform_priorities
    cfg = family_cfg("fpn_learn_nms")
    if kind == "rcnn_sampled":
        cfg.TRAIN.LEARN_NMS = False
        cfg.TRAIN.BATCH_ROIS = 16
        cfg.TRAIN.ENABLE_OHEM = False
    model = build_model(cfg, tiny=True, device="cpu")
    batch = _u8_rcnn_batch()
    B, R, G = batch["rois"].shape[0], batch["rois"].shape[1], batch["gt_boxes"].shape[1]
    if kind == "rpn":
        step = make_train_step_rpn(model, cfg, max_gt=G, device="cpu")
    else:
        step = make_train_step_rcnn(model, cfg, max_rois=R, max_gt=G,
                                    device="cpu")

    def run(priorities):
        init_params(model, seed=1)
        state = create_train_state(model, cfg, seed=9)
        _, m = step(state, batch, priorities)
        return ({k: float(v) for k, v in m.items()},
                state.generator.get_state())
    got, after = run(None)
    gen = torch.Generator().manual_seed(9)
    if kind == "rpn":
        with torch.no_grad():
            _, rpn_out = model.features_and_rpn(
                torch.zeros(batch["image"].shape, dtype=torch.float32))
        K = rpn_rows_fn(model, cfg, "cpu")(
            {s: (c[0], r[0]) for s, (c, r) in rpn_out.items()})[0].shape[0]
        prio = [{"anchor": uniform_priorities(gen, 2, K, "cpu")}
                for _ in range(B)]
    elif kind == "rcnn_sampled":
        prio = [{"sample": uniform_priorities(gen, 4, R + G, "cpu")}
                for _ in range(B)]
    else:
        prio = [{} for _ in range(B)]
    want, _ = run(prio)
    assert got == want and np.isfinite(got["total_loss"])
    assert torch.equal(after, gen.get_state())
    untouched = torch.equal(after, torch.Generator().manual_seed(9).get_state())
    assert untouched == (kind == "rcnn_take_all")
