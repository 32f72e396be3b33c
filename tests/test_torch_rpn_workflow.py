"""Port parity of the alternate (cached-proposal) workflow:
relation_tpu/core/rpn_workflow.py and predictor.make_predict_fn_rcnn (JAX,
CPU) against relation_tpu_torch on the same numpy inputs, the checks of
tests/test_rpn_workflow.py held against JAX:

- the proposal dump of the tiny C4 and FPN models on a fake loader (boxes,
  score order, and each package's pickle read by the other's
  load_proposal_roidb);
- the host-side functions, exactly equal on the same arrays;
- one RPN-only step (C4 and FPN) and one RCNN step on cached ROIs (the
  learned-NMS + relation family under train_shared, the sampled mode with
  custom bbox statistics), fed the priorities the JAX steps draw, in the
  bands of tests/test_torch_train.py::test_train_step_matches_jax_and_golden;
- prediction from cached proposals through the greedy, soft-NMS and learned
  tails, with padded ROIs;
- the driver's synthetic run, whose checkpoint the JAX package loads.

Where the JAX model reaches the Pallas geometric bias, it runs the jnp
reference (exact sin/cos, the formula the port implements), as in
tests/test_torch_train.py.
"""

import pickle

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import relation_tpu.core.rpn_workflow as jw
import relation_tpu.utils.native as jnative
import relation_tpu_torch.core.rpn_workflow as tw
from relation_tpu_torch.utils.native import bbox_overlaps
from tests.test_golden_e2e import _fixed_input, family_cfg
from tests.test_golden_train import _fixed_batch
from tests.test_torch_checkpoint import _jax_state
from tests.test_torch_helpers import flat_numpy, jax_tiny_family, n, port_model
from tests.test_torch_train import _exact_trig_jax

J = jnp.asarray
FPN_STRIDES = (64, 32, 16, 8, 4)


def _images(k=3, size=64, seed=5):
    r = np.random.RandomState(seed)
    return [(i, (r.randn(size, size, 3) * 40).astype(np.float32),
             np.asarray([size, size, 1.0], np.float32)) for i in range(k)]


def _proposal_cfg(name):
    cfg = family_cfg(name)
    cfg.TPU.FPN_TOPK = "exact"
    cfg.TEST.PROPOSAL_PRE_NMS_TOP_N = 96
    cfg.TEST.PROPOSAL_POST_NMS_TOP_N = 32
    cfg.TEST.PROPOSAL_MIN_SIZE = 0
    return cfg


def _gt_roidb(k=3):
    return [{"image": f"im{i}", "image_id": i, "height": 64, "width": 64,
             "boxes": np.asarray([[5, 5, 30, 30], [20, 25, 50, 55]], np.float32),
             "gt_classes": np.asarray([1, 2], np.int32),
             "iscrowd": np.zeros(2, bool), "flipped": False} for i in range(k)]


def _jax_rpn(jmodel, params, image):
    """The JAX model's RPN outputs on one image, as CPU tensors in the
    port's layout (C4: (feat, rpn_cls, rpn_bbox); FPN: (pyramid, {stride:
    (cls, bbox)}))."""
    out = jmodel.apply({"params": params}, J(image),
                       method=type(jmodel).features_and_rpn)
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), out)


@pytest.mark.parametrize("name", ["plain_learn_nms", "fpn_learn_nms"])
def test_proposal_dump_matches_jax_and_pickles_cross_read(name, tmp_path,
                                                          monkeypatch):
    """The dumped proposals of both packages, as many an image, scores in
    descending order: handed the JAX trunk's RPN outputs, the port's boxes
    within 1e-4 px and scores within 1e-5; from its own trunk (the two
    frameworks' f32 convolutions round differently) boxes within 1e-3 px.
    Each package's load_proposal_roidb reads the other's pickle to the same
    roidb; loader=None reads the roidb's image files through the TestLoader
    (a roidb of no files raises; tests/test_torch_evaluator.py dumps a
    dataset's)."""
    cfg = _proposal_cfg(name)
    jmodel, params = jax_tiny_family(cfg)
    items = _images()
    jpath = str(tmp_path / "jax.pkl")
    with _exact_trig_jax():
        jw.generate_rpn_proposals(jmodel, params, cfg, None, jpath, loader=items)
        rpn = [_jax_rpn(jmodel, params, img) for _, img, _ in items]
    with open(jpath, "rb") as f:
        want = pickle.load(f)
    model = port_model(cfg, params)
    got = {}
    for mode, atol in (("own", 1e-3), ("jax_rpn", 1e-4)):
        if mode == "jax_rpn":
            feed = iter(rpn)
            monkeypatch.setattr(model, "features_and_rpn", lambda image: next(feed))
        path = str(tmp_path / f"{mode}.pkl")
        tw.generate_rpn_proposals(model, cfg, None, path, loader=items,
                                  device="cpu")
        with open(path, "rb") as f:
            got[mode] = pickle.load(f)
        assert len(got[mode]) == len(want) == len(items)
        for g, w in zip(got[mode], want):
            assert g.dtype == np.float32 and g.shape == w.shape and len(w) > 8
            np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=atol,
                                       err_msg=mode)
            np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=0, atol=1e-5,
                                       err_msg=mode)
            assert (np.diff(g[:, 4]) <= 0).all()
    roidb = _gt_roidb()
    for path in (jpath, str(tmp_path / "own.pkl")):
        a = jw.load_proposal_roidb(roidb, path, top_rois=20)
        b = tw.load_proposal_roidb(roidb, path, top_rois=20)
        for ea, eb in zip(a, b):
            assert set(ea) == set(eb)
            np.testing.assert_array_equal(ea["proposals"], eb["proposals"])
    with pytest.raises(FileNotFoundError, match="im0"):
        tw.generate_rpn_proposals(model, cfg, roidb, jpath, device="cpu")


def _recall_equal(a, b):
    assert set(a) == set(b)
    for k in ("ar", "num_gt"):
        assert a[k] == b[k], k
    np.testing.assert_array_equal(a["recalls"], b["recalls"])
    assert a["proposal_area_pct"] == b["proposal_area_pct"]
    for name, v in a["areas"].items():
        for k in ("recalls", "thresholds"):
            np.testing.assert_array_equal(v[k], b["areas"][name][k])
        assert (v["ar"], v["num_pos"]) == (b["areas"][name]["ar"],
                                           b["areas"][name]["num_pos"])


def test_host_functions_equal_jax(tmp_path):
    """bbox_overlaps (against JAX's native library and its NumPy fallback),
    evaluate_recall (random proposals over crowd-marked roidbs; and the two
    unit cases of tests/test_rpn_workflow.py: the area breakdown and the
    one-to-one greedy match), add_bbox_regression_stats (agnostic and per
    class, with crowds), load_proposal_roidb: exactly equal."""
    rng = np.random.RandomState(0)
    xy = rng.uniform(0, 300, (200, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(-5, 200, (200, 2))], 1)
    boxes = boxes.astype(np.float32)
    query = boxes[rng.randint(0, 200, 30)] + rng.uniform(-9, 9, (30, 4))
    query = query.astype(np.float32)
    want = jnative.bbox_overlaps(boxes, query)
    np.testing.assert_array_equal(bbox_overlaps(boxes, query), want)
    saved = jnative._lib
    jnative._lib = False
    try:
        np.testing.assert_array_equal(bbox_overlaps(boxes, query),
                                      jnative.bbox_overlaps(boxes, query))
    finally:
        jnative._lib = saved

    roidb, props = [], []
    for i in range(4):
        g = rng.randint(1, 6)
        xy = rng.uniform(0, 400, (g, 2))
        gt = np.concatenate([xy, xy + rng.uniform(10, 350, (g, 2))], 1)
        crowd = rng.uniform(0, 1, g) < 0.2
        classes = rng.randint(0 if i == 3 else 1, 4, g)
        roidb.append({"boxes": gt.astype(np.float32), "gt_classes": classes,
                      "iscrowd": crowd})
        p = np.repeat(gt, 6, 0) + rng.uniform(-30, 30, (6 * g, 4))
        p = np.concatenate([p, rng.uniform(0, 1, (6 * g, 1))], 1)
        props.append(p.astype(np.float32))
    props[2] = props[2][:0]
    _recall_equal(tw.evaluate_recall(roidb, props),
                  jw.evaluate_recall(roidb, props))
    _recall_equal(tw.evaluate_recall(roidb, props, thresholds=[0.5, 0.7]),
                  jw.evaluate_recall(roidb, props, thresholds=[0.5, 0.7]))
    gt = np.asarray([[0, 0, 19, 19], [100, 100, 159, 159]], np.float32)
    unit = [{"boxes": gt, "gt_classes": np.asarray([1, 1]),
             "iscrowd": np.zeros(2, bool)}]
    one = [np.asarray([[0, 0, 19, 19, 0.9]], np.float32)]
    rec = tw.evaluate_recall(unit, one)
    _recall_equal(rec, jw.evaluate_recall(unit, one))
    np.testing.assert_allclose(rec["areas"]["0-25"]["recalls"], 1.0)
    assert rec["areas"]["50-100"]["num_pos"] == 1
    unit[0]["boxes"] = np.asarray([[0, 0, 19, 19], [2, 2, 21, 21]], np.float32)
    rec = tw.evaluate_recall(unit, one, thresholds=[0.5])
    _recall_equal(rec, jw.evaluate_recall(unit, one, thresholds=[0.5]))
    assert rec["areas"]["all"]["recalls"][0] == 0.5

    with open(tmp_path / "p.pkl", "wb") as f:
        pickle.dump(props, f)
    for top in (-1, 5):
        a = jw.load_proposal_roidb(roidb, str(tmp_path / "p.pkl"), top)
        b = tw.load_proposal_roidb(roidb, str(tmp_path / "p.pkl"), top)
        for ea, eb in zip(a, b):
            np.testing.assert_array_equal(ea["proposals"], eb["proposals"])
        for agnostic in (True, False):
            for ws, js in zip(tw.add_bbox_regression_stats(b, 4, agnostic, 0.5),
                              jw.add_bbox_regression_stats(a, 4, agnostic, 0.5)):
                np.testing.assert_array_equal(ws, js)


# --------------------------------------------------------------------------
# the RPN and RCNN steps against JAX
# --------------------------------------------------------------------------

def _step_keys(B, step=0):
    """The JAX steps' per-image keys: split(fold_in(rng, step), B)."""
    return jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), step), B)


def _rcnn_batch(R=20, pad=3, seed=0):
    """_fixed_batch with R cached ROIs an image (the last ``pad`` flagged as
    padding), some of them around the ground truth. The padded rows keep
    their random boxes: with the drivers' zero-size boxes there, the
    learned-NMS branch's nms_pair_pos_fc1 gradient is ill-conditioned in
    JAX itself (1e-6 relative noise on its inputs moves it by up to 5% of
    its largest element), so the two packages' convolutions, which differ
    by that much, part it beyond the band; given equal head outputs they
    agree (test_learned_nms_on_zero_size_padded_rois_matches_jax)."""
    batch = _fixed_batch()
    r = np.random.RandomState(seed)
    B = batch["image"].shape[0]
    xy = r.uniform(0, 36, (B, R, 2))
    rois = np.concatenate([xy, xy + r.uniform(8, 28, (B, R, 2))], -1)
    rois[:, :4] = batch["gt_boxes"][:, :2, :4].repeat(2, 1) + r.uniform(
        -3, 3, (B, 4, 4))
    valid = np.arange(R)[None].repeat(B, 0) < R - pad
    return dict(batch, rois=rois.astype(np.float32), rois_valid=valid)


def _assert_step_matches(cfg, metrics, j_metrics, before, after, j_after, mask):
    """The bands of test_train_step_matches_jax_and_golden; frozen leaves
    bit-equal in both packages."""
    assert set(metrics) == set(j_metrics)
    for k, want in j_metrics.items():
        assert np.isfinite(metrics[k])
        assert metrics[k] == pytest.approx(want, rel=1e-4, abs=1e-7), k
    moved = 0
    for k in before:
        if not mask[k]:
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)
            np.testing.assert_array_equal(j_after[k], before[k], err_msg=k)
            continue
        want = j_after[k] - before[k]
        atol = 5e-6 if "pair_pos_fc1" in k else 1e-6
        np.testing.assert_allclose(after[k] - before[k], want, rtol=1e-3,
                                   atol=atol, err_msg=k)
        moved += int(np.abs(want).max() > 0)
    assert moved > 0


def _trainable(params, prefixes):
    from flax.traverse_util import flatten_dict
    from relation_tpu.core.trainer import trainable_mask
    return {"/".join(k): v for k, v in flatten_dict(
        trainable_mask(params, tuple(prefixes))).items()}


@pytest.mark.parametrize("name", ["plain_learn_nms", "fpn_learn_nms"])
def test_rpn_step_matches_jax(name):
    """One RPN-only step, anchor subsampling fed the uniforms the JAX step
    draws from each image's key (split into fg and bg): metrics and updates
    in the bands of the end-to-end step; the head's leaves move by weight
    decay alone in both packages."""
    from relation_tpu_torch.convert import to_jax_params
    from relation_tpu_torch.core.trainer import create_train_state
    cfg = family_cfg(name)
    _, params = jax_tiny_family(cfg)
    batch = _fixed_batch()
    B, size = batch["image"].shape[:2]
    with _exact_trig_jax():
        jmodel = jax_tiny_family(cfg)[0]
        state = _jax_state(cfg, params, cfg.network.FIXED_PARAMS)
        state2, jm = jax.jit(jw.make_train_step_rpn(jmodel, cfg, max_gt=4))(
            state, jax.tree.map(J, batch))
    fpn = name.startswith("fpn")
    K = (sum((size // s) ** 2 for s in FPN_STRIDES) if fpn
         else (size // 16) ** 2) * int(cfg.network.NUM_ANCHORS)
    prio = []
    for key in _step_keys(B):
        k_fg, k_bg = jax.random.split(key)
        prio.append({"anchor": (np.array(jax.random.uniform(k_fg, (K,))),
                                np.array(jax.random.uniform(k_bg, (K,))))})
    model = port_model(cfg, params)
    pstate = create_train_state(model, cfg)
    pstate, m = tw.make_train_step_rpn(model, cfg, max_gt=4, device="cpu")(
        pstate, batch, priorities=prio)
    assert (pstate.step, pstate.count) == (1, 1)
    _assert_step_matches(cfg, {k: float(v) for k, v in m.items()},
                         {k: float(v) for k, v in jm.items()},
                         flat_numpy(params), to_jax_params(model.state_dict()),
                         flat_numpy(state2.params),
                         _trainable(params, cfg.network.FIXED_PARAMS))


RCNN_CASES = {
    # the learned-NMS + relation family on a trunk shared with the RPN
    # (the tiny trunk frozen as the YAMLs' FIXED_PARAMS_SHARED freeze theirs)
    "learn_nms_train_shared": ("plain_learn_nms", ["tiny", "gamma", "beta"],
                               None),
    # the FPN learned-NMS YAML's step: pool_pyramid, the neck trained, the
    # tiny trunk's res2-res4 stand-ins frozen
    "fpn_learn_nms_train_shared": ("fpn_learn_nms",
                                   ["t2", "t3", "t4", "gamma", "beta"], None),
    # sampled mode, 16 ROIs, roidb-computed statistics
    "sampled_custom_stats": ("plain", None,
                             ((0.01, -0.02, 0.1, 0.05), (0.1, 0.1, 0.2, 0.2))),
}


@pytest.mark.parametrize("case", sorted(RCNN_CASES))
def test_rcnn_step_matches_jax(case):
    """One RCNN step on cached ROIs (three padded an image), "sample"
    priorities drawn as the JAX step draws them (split(key, 4), only in
    sampled mode). Metrics and updates in the end-to-end step's bands;
    under train_shared the FIXED_PARAMS_SHARED leaves stay bit-equal while
    the head moves; the RPN's leaves move by weight decay alone."""
    from relation_tpu_torch.convert import to_jax_params
    from relation_tpu_torch.core.trainer import create_train_state, refreeze_state
    name, shared_prefixes, stats = RCNN_CASES[case]
    shared = shared_prefixes is not None
    cfg = family_cfg(name)
    if stats is not None:
        cfg.TRAIN.LEARN_NMS = cfg.TEST.LEARN_NMS = False
        cfg.TRAIN.ENABLE_OHEM = False
        cfg.TRAIN.BATCH_ROIS = 16
        cfg.TRAIN.BBOX_NORMALIZATION_PRECOMPUTED = False
    if shared:
        cfg.network.FIXED_PARAMS_SHARED = shared_prefixes
    fixed = cfg.network.FIXED_PARAMS_SHARED if shared else cfg.network.FIXED_PARAMS
    _, params = jax_tiny_family(cfg)
    batch = _rcnn_batch()
    B, R = batch["rois"].shape[:2]
    G = batch["gt_boxes"].shape[1]
    kw = dict(max_rois=R, max_gt=G, train_shared=shared)
    if stats is not None:
        kw.update(bbox_means=stats[0], bbox_stds=stats[1])
    with _exact_trig_jax():
        jmodel = jax_tiny_family(cfg)[0]
        state2, jm = jax.jit(jw.make_train_step_rcnn(jmodel, cfg, **kw))(
            _jax_state(cfg, params, fixed), jax.tree.map(J, batch))
    prio = [{} if stats is None else {"sample": tuple(
        np.array(jax.random.uniform(k, (R + G,)))
        for k in jax.random.split(key, 4))} for key in _step_keys(B)]
    model = port_model(cfg, params)
    pstate = create_train_state(model, cfg)
    if shared:
        pstate = refreeze_state(pstate, cfg, cfg.network.FIXED_PARAMS_SHARED)
    pstate, m = tw.make_train_step_rcnn(model, cfg, device="cpu", **kw)(
        pstate, batch, priorities=prio)
    metrics = {k: float(v) for k, v in m.items()}
    if stats is None:
        assert {"nms_pos_loss", "nms_acc_neg"} <= set(metrics)
    mask = _trainable(params, fixed)
    before, after = flat_numpy(params), to_jax_params(model.state_dict())
    _assert_step_matches(cfg, metrics, {k: float(v) for k, v in jm.items()},
                         before, after, flat_numpy(state2.params), mask)
    if shared:
        assert not any(v for k, v in mask.items() if k.startswith("c4/"))
        assert any(np.any(after[k] != before[k]) for k in after
                   if k.startswith("relation_1/"))


def test_learned_nms_on_zero_size_padded_rois_matches_jax():
    """The RCNN step's learned-NMS branch and its losses on the first 20
    ROIs of an image whose last three are the drivers' zero-size padding,
    both packages handed the JAX head's outputs: the loss at 1e-6 relative,
    the sorted boxes equal, every gradient of the learned-NMS head within
    1e-4 of its largest element (nms_key's bias, whose gradient is zero up
    to rounding, against the key kernel's largest)."""
    import relation_tpu.models.losses as jl
    import relation_tpu.models.targets as jt
    import relation_tpu_torch.models.losses as tl
    import relation_tpu_torch.models.targets as tt
    cfg = family_cfg("plain_learn_nms")
    jmodel, params = jax_tiny_family(cfg)
    batch = _rcnn_batch()
    batch["rois"][:, -3:] = 0.0
    b, nongt = 1, 20
    rois = np.concatenate([batch["rois"][b], batch["gt_boxes"][b, :, :4]])
    gt, gv, info = (batch[k][b] for k in ("gt_boxes", "gt_valid", "im_info"))
    threshes = (0.5, 0.7)
    with _exact_trig_jax():
        feat = jmodel.apply({"params": params}, J(batch["image"][b:b + 1]),
                            method=type(jmodel).features_and_rpn)[0][0]
        head = [x[:nongt] for x in jmodel.apply(
            {"params": params}, feat, J(rois), nongt, method=type(jmodel).head)]

        def loss(p):
            ln = jmodel.apply({"params": p}, *head[:2], J(rois[:nongt]), head[2],
                              J(info), method=type(jmodel).learn_nms)
            nt = jt.nms_multi_target(ln["sorted_bbox"], J(gt), J(gv),
                                     jax.lax.stop_gradient(ln["sorted_score"]),
                                     threshes)
            return jl.learn_nms_losses(ln["nms_multi_score"], nt,
                                       float(cfg.TRAIN.nms_loss_scale),
                                       float(cfg.TRAIN.nms_pos_scale))[0], ln
        (want, jln), grads = jax.value_and_grad(loss, has_aux=True)(params)
    want_g = flat_numpy(grads)
    model = port_model(cfg, params)
    cs, bp, fc2 = (torch.from_numpy(np.array(x)) for x in head)
    ln = model.learn_nms(cs, bp, torch.from_numpy(rois[:nongt]), fc2,
                         torch.from_numpy(info))
    nt = tt.nms_multi_target(ln["sorted_bbox"], torch.from_numpy(gt),
                             torch.from_numpy(gv), ln["sorted_score"].detach(),
                             threshes)
    got = tl.learn_nms_losses(ln["nms_multi_score"], nt,
                              float(cfg.TRAIN.nms_loss_scale),
                              float(cfg.TRAIN.nms_pos_scale))[0]
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_array_equal(n(ln["sorted_bbox"]), np.asarray(jln["sorted_bbox"]))
    from relation_tpu_torch.convert import to_jax_params
    got_g = to_jax_params({k: p.grad for k, p in model.named_parameters()
                           if k.startswith("learn_nms_head") and p.grad is not None})
    assert len(got_g) > 10
    for k, g in got_g.items():
        ref = want_g["/".join(k.split("/")[:-1]) + "/kernel"] if k.endswith(
            "nms_key_1/bias") else want_g[k]
        np.testing.assert_allclose(g, want_g[k], rtol=0,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=k)


def test_rcnn_step_refuses_and_draws():
    """The RCNN step defaults to the card (raises without one), refuses a
    stop_after cut that the JAX RCNN step does not have, LEARN_NMS with sampled ROIs and more ROIs than
    max_rois; generator-drawn priorities repeat under one seed; no_grad
    leaves the parameters and the count alone."""
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.trainer import build_model, create_train_state
    cfg = family_cfg("plain_learn_nms")
    model = init_params(build_model(cfg, tiny=True, device="cpu"), seed=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tw.make_train_step_rcnn(model, cfg, max_rois=20, max_gt=4)
        with pytest.raises(RuntimeError, match="cuda"):
            tw.make_train_step_rpn(model, cfg, max_gt=4)
    with pytest.raises(ValueError, match="stop_after"):
        tw.make_train_step_rcnn(model, cfg, 20, 4, stop_after="rpn",
                                device="cpu")
    bad = cfg.copy()
    bad.TRAIN.BATCH_ROIS = 16
    with pytest.raises(ValueError, match="BATCH_ROIS"):
        tw.make_train_step_rcnn(model, bad, 20, 4, device="cpu")
    batch = _rcnn_batch()
    with pytest.raises(ValueError, match="max_rois"):
        tw.make_train_step_rcnn(model, cfg, 8, 4, device="cpu")(
            create_train_state(model, cfg), batch)
    step = tw.make_train_step_rcnn(model, cfg, 20, 4, device="cpu")

    def run(seed):
        init_params(model, seed=1)
        state = create_train_state(model, cfg, seed=seed)
        return [float(step(state, batch)[1]["total_loss"]) for _ in range(2)]
    first = run(5)
    assert first == run(5) and first[0] != first[1]
    state = create_train_state(model, cfg)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    state, m = tw.make_train_step_rcnn(model, cfg, 20, 4, no_grad=True,
                                       device="cpu")(state, batch)
    assert (state.step, state.count) == (1, 0) and np.isfinite(float(
        m["total_loss"]))
    assert all(torch.equal(v, sd[k]) for k, v in model.state_dict().items())


# --------------------------------------------------------------------------
# prediction from cached proposals
# --------------------------------------------------------------------------

TAILS = {"greedy": ("plain_relation", dict(NMS=0.5, SOFTNMS=False)),
         "soft_nms": ("plain", dict(NMS=0.5, SOFTNMS=True)),
         "learned": ("plain_learn_nms", {}),
         # the FPN learned-NMS YAML's test: pool_pyramid, then the same tail
         "fpn_learned": ("fpn_learn_nms", {})}


@pytest.mark.parametrize("tail", sorted(TAILS))
def test_predict_rcnn_matches_jax(tail):
    """make_predict_fn_rcnn against JAX's on the fixed image and 20 cached
    ROIs of which 5 are padding: dets at 1e-4. The learned tail runs with
    no class threshold, however TEST.LEARN_NMS_CLASS_SCORE_TH is set (its
    padded ROIs are keys of the head's relation modules, as in JAX)."""
    from relation_tpu.core.predictor import make_predict_fn_rcnn as j_make
    from relation_tpu_torch.core.predictor import make_predict_fn_rcnn
    name, test = TAILS[tail]
    cfg = family_cfg(name)
    cfg.TEST.HAS_RPN = False
    cfg.TEST.update(test)
    cfg.TEST.LEARN_NMS_CLASS_SCORE_TH = 0.3
    img, info = _fixed_input()
    r = np.random.RandomState(2)
    xy = r.uniform(0, 40, (20, 2))
    rois = np.concatenate([xy, xy + r.uniform(10, 24, (20, 2))], 1)
    rois = rois.astype(np.float32)
    valid = np.arange(20) < 15
    rois[~valid] = 0.0
    with _exact_trig_jax():
        jmodel, params = jax_tiny_family(cfg)
        want = jax.jit(j_make(jmodel, cfg))(params, J(img), J(info), J(rois),
                                            J(valid))
    model = port_model(cfg, params)
    got = make_predict_fn_rcnn(model, cfg)(img, info, rois, valid)
    d, w = n(got["dets"]), np.asarray(want["dets"])
    assert d.shape == w.shape == (int(cfg.TEST.max_per_image), 6)
    assert (w[:, 0] >= 0).sum() > 2
    np.testing.assert_array_equal(d[:, 0], w[:, 0])
    np.testing.assert_allclose(d[:, 1:], w[:, 1:], rtol=0, atol=1e-4)
    if tail.endswith("learned"):
        np.testing.assert_allclose(n(got["final_score"]),
                                   np.asarray(want["final_score"]), rtol=0,
                                   atol=1e-4)


def test_driver_synthetic_run_loads_in_jax(tmp_path, monkeypatch):
    """The driver on two synthetic images, two steps a stage, the tiny FPN
    model of the FPN learned-NMS YAML with --train-shared, on the CPU: the
    proposal pickle and both files exist, the pickle holds two float32
    [N, 5] arrays, JAX's load_params reads the checkpoint into the JAX
    model's tree and gives the port's parameters; a dataset raises."""
    import os
    from relation_tpu.config.defaults import load_config
    from relation_tpu.core.checkpoint import load_params
    from relation_tpu_torch.convert import to_jax_params
    from relation_tpu_torch.core.checkpoint import load_params as t_load
    from relation_tpu_torch.core.trainer import build_model
    from relation_tpu_torch.experiments.rcnn_train_test import main
    yaml = os.path.join(os.path.dirname(__file__), "..", "experiments", "cfgs",
                        "resnet_v1_101_coco_trainvalminus_rcnn_fpn_relation_"
                        "learn_nms_8epoch.yaml")
    monkeypatch.chdir(tmp_path)
    out = main(["--cfg", yaml, "--synthetic", "2", "--steps", "2", "--tiny",
                "--device", "cpu", "--train-shared"])
    for k in ("proposals", "checkpoint", "params"):
        assert os.path.exists(out[k]), k
    with open(out["proposals"], "rb") as f:
        props = pickle.load(f)
    assert len(props) == 2 and all(p.dtype == np.float32 and p.shape[1] == 5
                                   for p in props)
    assert np.isfinite(out["metrics"]["total_loss"])
    cfg = load_config(yaml)
    _, template = jax_tiny_family(cfg)
    loaded = flat_numpy(load_params(out["checkpoint"], template))
    port = build_model(cfg, tiny=True, device="cpu")
    want = to_jax_params(t_load(out["params"], port))
    assert set(loaded) == set(want)
    assert all(np.array_equal(loaded[k], want[k]) for k in want)
    with pytest.raises(FileNotFoundError, match="instances_"):
        main(["--cfg", yaml, "--dataset-path", str(tmp_path), "--device", "cpu",
              "--tiny"])


@pytest.mark.parametrize("family,yaml", [
    ("fpn", "rcnn_fpn_8epoch"), ("fpn_relation", "rcnn_fpn_relation_8epoch"),
    ("fpn_learn_nms", "rcnn_fpn_relation_learn_nms_8epoch")])
def test_family_cfg_carries_the_workflow_keys_of_the_fpn_yaml(family, yaml):
    """entry.py::family_cfg against the FPN YAML (read by the JAX package's
    loader) on the keys of the alternate workflow: the trunk shared with the
    RPN, one image a batch, the proposal dump's settings, TOP_ROIS."""
    import os
    from relation_tpu.config.defaults import load_config
    from relation_tpu_torch.entry import family_cfg as port_family_cfg
    want = load_config(os.path.join(os.path.dirname(__file__), "..", "experiments",
                                    "cfgs",
                                    f"resnet_v1_101_coco_trainvalminus_{yaml}.yaml"))
    got = port_family_cfg(family)
    assert list(got.network.FIXED_PARAMS_SHARED) == list(
        want.network.FIXED_PARAMS_SHARED)
    assert not want.TRAIN.END2END and not want.TEST.HAS_RPN
    for sec, keys in (("TRAIN", ("BATCH_IMAGES", "TOP_ROIS")),
                      ("TEST", ("PROPOSAL_PRE_NMS_TOP_N", "PROPOSAL_POST_NMS_TOP_N",
                                "PROPOSAL_NMS_THRESH", "PROPOSAL_MIN_SIZE",
                                "TOP_ROIS"))):
        for k in keys:
            assert got[sec][k] == want[sec][k], f"{sec}.{k}"
