"""The port's deformable detector against the benchmark's plain reference of
it (benchmark/reference/dcn.py, plain PyTorch written from the published
description, no code of the port), on the CPU:

- the deformable conv and the deformable PSROI pool, with their gradients,
  at non-zero offsets;
- one END2END train step (core/trainer.py::make_train_step) against the
  reference's ``train_steps`` on the same seeded weights, batch and anchor
  priorities: the loss, the first gradients and the update;
- one request (core/predictor.py::build_predict_fn) against the reference's
  ``predict``;
- with the registry on, the step's deformable spans and sample counters.

The reference knows only the published widths, so the model is the
``dcn_learn_nms`` configuration of the benchmark at its CPU rehearsal size
(benchmark/harness/common.py::rehearsal): every width, a 64x128 image, the
tiny proposal counts, two images a batch.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.harness import cells, compare
from benchmark.harness.common import rehearsal
from benchmark.reference import dcn as ref
from relation_tpu_torch.utils import trace

CELL = "dcn_learn_nms.train_b4"


def _offsets(rng, shape, spread):
    """Uniform offsets kept 1e-3 clear of integers, where a bilinear weight's
    slope jumps."""
    off = rng.uniform(-spread, spread, shape)
    off = np.where(np.abs(off - np.round(off)) < 1e-3, off + 2e-3, off)
    return torch.tensor(off, dtype=torch.float32)


@pytest.fixture(scope="module")
def built():
    """(config, mix, ctx, driver) of the rehearsal-size cell, seed 5."""
    spec = cells.resolve(CELL)
    config, mix = rehearsal(spec["config"], spec["mix"])
    ctx = {"config": config, "reference": ref, "mix": mix, "seed": 5,
           "device": torch.device("cpu"), "rehearse": True, "fault": ""}
    return config, mix, ctx, cells.driver(mix["kind"])


def test_deformable_conv_and_its_gradients_match_the_reference():
    from relation_tpu_torch.ops.deform import deformable_conv_batched
    rng = np.random.RandomState(0)
    B, H, W, C, O, G = 2, 7, 9, 16, 12, 4
    x = torch.tensor(rng.randn(B, C, H, W), dtype=torch.float32)
    off = _offsets(rng, (B, G * 18, H, W), 2.5)
    w = torch.tensor(rng.randn(O, C, 3, 3) * 0.2, dtype=torch.float32)
    dout = torch.tensor(rng.randn(B, O, H, W), dtype=torch.float32)

    def grads(fn):
        ins = [t.clone().requires_grad_(True) for t in (x, off, w)]
        y = fn(*ins)
        return [y.detach()] + list(torch.autograd.grad((y * dout).sum(), ins))
    want = grads(lambda a, o, k: ref.deform_conv(a, o, k, 2, G))
    got = grads(lambda a, o, k: deformable_conv_batched(
        a.permute(0, 2, 3, 1), o.permute(0, 2, 3, 1), k.permute(2, 3, 1, 0),
        kernel=3, dilation=2, num_groups=G).permute(0, 3, 1, 2))
    for name, g, r in zip(("out", "dx", "doffset", "dw"), got, want):
        assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max()), name
    # the offsets move samples: the output is not the plain dilated conv's
    plain = torch.nn.functional.conv2d(x, w, None, 1, 2, 2)
    assert float((want[0] - plain).abs().max()) > 0.1 * float(plain.abs().max())


@pytest.mark.parametrize("with_trans", [False, True])
def test_deformable_psroi_pool_and_its_gradients_match_the_reference(with_trans):
    from relation_tpu_torch.ops.deform import deformable_psroi_pool
    rng = np.random.RandomState(1)
    C, H, W, R = 8, 6, 10, 37
    feat = torch.tensor(rng.randn(C, H, W), dtype=torch.float32)
    x1 = rng.uniform(-8, 140, R)
    y1 = rng.uniform(-8, 80, R)
    rois = torch.tensor(np.stack([x1, y1, x1 + rng.uniform(0, 90, R),
                                  y1 + rng.uniform(0, 60, R)], 1),
                        dtype=torch.float32)
    trans = _offsets(rng, (R, 2, 7, 7), 1.5) if with_trans else None
    dout = torch.tensor(rng.randn(R, 7, 7, C), dtype=torch.float32)

    def grads(fn):
        f = feat.clone().requires_grad_(True)
        t = trans.clone().requires_grad_(True) if with_trans else None
        y = fn(f, t)
        ins = [f] + ([t] if with_trans else [])
        return [y.detach()] + list(torch.autograd.grad((y * dout).sum(), ins))
    want = grads(lambda f, t: ref.psroi_pool(f, rois, t))
    got = grads(lambda f, t: deformable_psroi_pool(
        f.permute(1, 2, 0), rois, t, 1.0 / 16, pooled_size=7,
        sample_per_part=4, trans_std=0.1))
    for name, g, r in zip(("out", "dfeat", "dtrans"), got, want):
        assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max()), name
    # bins outside the map read 0 on both sides; some bins are empty here
    assert bool((want[0].abs().sum(-1) == 0).any())


def test_one_end2end_step_matches_the_reference(built):
    """Losses to 1e-5, the median leaf's first-gradient gap to 1e-5, the
    worst leaf's to 1e-3 but for the relation modules' geometric-bias
    leaves (``pair_pos_fc1``, whose gradient passes 1/acc at the log's
    clamp: 4.2e-4 and 9.1e-3 at seeds 6 and 5; the res5 offset convs come
    next, 2.6e-4 and 3.8e-4), those to 5e-2, the median leaf's update to
    1e-5; the offset leaves and the deformable weights all move."""
    config, mix, ctx, driver = built
    model, state, step, W, batches = driver.build(ctx)
    wd = float(config["train"]["wd"])
    state, m = step(state, batches[0])
    grad = {k: float((t - wd * W[k]).norm()) for k, t in state.trace.items()}
    params = dict(model.named_parameters())
    change = {k: float((params[k].detach() - W[k]).norm()) for k in state.trace}
    r_losses, r_first, r_final = ref.train_steps(W, config, batches[:1], 1)
    skip, r_grad, _ = compare.nongrad_floor(r_first)
    r_change = {k: float((v - W[k]).norm()) for k, v in r_final.items()}
    assert set(grad) == set(r_grad)
    assert compare.math_rel(float(m["total_loss"]), r_losses[0]) <= 1e-5
    assert compare.median_leaf_gap(grad, r_grad, skip) <= 1e-5
    gaps = compare.leaf_gaps(grad, r_grad, skip)
    bias = {k for k in gaps if ".pair_pos_fc1_" in k}
    assert len(bias) == 4 and max(gaps[k] for k in bias) <= 5e-2
    assert max(v for k, v in gaps.items() if k not in bias) <= 1e-3
    assert compare.median_leaf_gap(change, r_change, skip) <= 1e-5
    moving = [k for k in grad if "offset" in k or k.endswith("branch2b_weight")]
    assert len(moving) == 3 * 3 + 2
    assert all(change[k] > 0 and r_change[k] > 0 for k in moving)


def test_predict_matches_the_reference(built):
    from relation_tpu_torch.core.predictor import build_predict_fn
    from relation_tpu_torch.core.trainer import build_model
    from benchmark.harness import traffic
    from benchmark.harness.common import program_cfg
    from benchmark.harness.weights import make_weights
    config, _, ctx, _ = built
    W = make_weights(ref, config, 11, torch.device("cpu"))
    model = build_model(program_cfg(config, True), device="cpu")
    model.load_state_dict(W, strict=True)
    predict = build_predict_fn(model, program_cfg(config, True))
    imgs, infos = traffic.images(config, 2, 11, torch.device("cpu"))
    with torch.no_grad():
        for img, info in zip(imgs, infos):
            got = predict(img, info)["dets"]
            want = ref.predict(W, config, img, info)
            n, unmatched, widest, _, _ = compare.dets_gap(got, want, 50)
            assert n > 0 and unmatched == 0 and widest <= 1e-5


def test_step_records_the_deformable_spans_and_counts(built):
    """One step with the registry on: each deformable span opens, the two
    sample counters equal the hand counts of the step's shapes, and the only
    host reads are the plain NMS's, which the card does not run."""
    config, mix, ctx, driver = built
    model, state, step, W, batches = driver.build(ctx)
    trace.reset()
    trace.enable()
    try:
        step(state, batches[0])
        snap = trace.snapshot()
    finally:
        trace.disable()
        trace.reset()
    spans = {k: v["count"] for k, v in snap["spans"].items()}
    B = int(mix["batch_images"])
    assert spans["dcn.conv"] == spans["dcn.conv_bwd"] == spans["dcn.col2im"] == 3
    assert spans["dcn.pool"] == B
    h, w = driver.feature_size(config)
    rois = int(config["train"]["rpn_post_nms_top_n"]) + max(mix["gt_counts"])
    counters = snap["counters"]
    assert counters["dcn.conv.samples"] == 3 * B * h * w * 9 * 4
    assert counters["dcn.pool.samples"] == 2 * B * rois * 49 * 16
    reads = {k for k in counters if k.startswith("host_read.")}
    assert reads <= {"host_read.nms_live", "host_read.nms_kept"}
