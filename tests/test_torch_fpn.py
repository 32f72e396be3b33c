"""Port parity of the FPN slice: relation_tpu's FPN detector (res5 at stride
32, the FPN neck, the RPN over five levels, pyramid proposals, the ROI
level dispatch and 4-level pooled head, the XLA branch of the learned-NMS
attention) against relation_tpu_torch, on the same seeded numpy inputs and
parameters; the plain versions of the three kernels of that branch (skip
geometric bias, bias attention with and without class skipping) against
the Pallas kernels in interpret mode; the three FPN goldens through the
port's predict functions. f32 throughout; every tolerance is stated where
it is used."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tests.test_torch_helpers import jax_tiny_family, n, port_model, t
from tests.test_golden_e2e import _fixed_input, _load_fixture, family_cfg
from relation_tpu.models import fpn as jf
from relation_tpu_torch.convert import from_jax_params, init_params, to_jax_params
from relation_tpu_torch.core.predictor import (build_predict_fn, make_predict_fn,
                                               make_predict_fn_split)
from relation_tpu_torch.models import fpn as tf
from relation_tpu_torch.ops.kernels import bias_attention as tba, geom_bias as tgb

J = jnp.asarray


def _check_dets(got, want, box_tol=1e-2, score_tol=1e-4):
    """The bands of the C4 goldens (tests/test_torch_dcn.py): same classes
    in the same order, scores within 1e-4, boxes within 1e-2 px."""
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0, atol=score_tol)
    np.testing.assert_allclose(got[:, 2:], want[:, 2:], rtol=0, atol=box_tol)


def _boxes(rng, n_boxes, lo=4.0, hi=700.0, size=1000.0):
    """[n, 4] boxes whose sides span every dispatch level (16..700 px)."""
    xy = rng.uniform(0, size / 2, (n_boxes, 2))
    wh = np.exp(rng.uniform(np.log(lo), np.log(hi), (n_boxes, 2)))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _seeded(shapes, seed, scale=0.05):
    """{flax path: seeded normal array} for an abstract param tree, with
    BatchNorm statistics that are not the identity."""
    from flax.traverse_util import flatten_dict
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in flatten_dict(shapes, sep="/").items():
        leaf = k.rsplit("/", 1)[-1]
        if leaf == "moving_var":
            a = rng.uniform(0.5, 2.0, v.shape)
        elif leaf == "gamma":
            a = rng.uniform(0.8, 1.2, v.shape)
        elif leaf in ("beta", "moving_mean", "bias"):
            a = rng.randn(*v.shape) * 0.1
        else:
            fan_in = int(np.prod(v.shape[:-1]))
            a = rng.randn(*v.shape) / np.sqrt(fan_in)
        out[k] = a.astype(np.float32)
    return out


def _unflatten(flat):
    from flax.traverse_util import unflatten_dict
    return unflatten_dict({tuple(k.split("/")): J(v) for k, v in flat.items()})


# --------------------------------------------------------------------------
# dispatch, anchors, res5 + neck, proposals
# --------------------------------------------------------------------------

def test_roi_level_dispatch_and_fpn_anchors_are_exact():
    """The level of 500 ROIs of 4..700 px (every level, the clip at both
    ends) and the five anchor grids of a 608x1024 pyramid equal JAX's."""
    rng = np.random.RandomState(0)
    rois = _boxes(rng, 500)
    got = n(tf.roi_level_dispatch(t(rois)))
    want = np.asarray(jf.roi_level_dispatch(J(rois)))
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(want)) == {0, 1, 2, 3}
    shapes = {64: (10, 16), 32: (19, 32), 16: (38, 64), 8: (76, 128), 4: (152, 256)}
    got = tf.fpn_anchors(shapes, (8,), (0.5, 1, 2))
    want = jf.fpn_anchors(shapes, (8,), (0.5, 1, 2))
    assert sum(v.shape[0] for v in got.values()) == 3 * 51840
    for s in shapes:
        np.testing.assert_array_equal(n(got[s]), np.asarray(want[s]))


def test_res5_standard_and_neck_match_jax():
    """ResNet101C5Standard and FPNNeck at their real widths (1024 -> 2048
    res5; 256/512/1024/2048 -> 256 laterals) on res2..res4 maps of 8x16,
    4x8 and 2x4 cells, with seeded weights and BatchNorm statistics: every
    pyramid level within 1e-4 of its largest element."""
    rng = np.random.RandomState(1)
    feats = {2: rng.randn(1, 8, 16, 256), 3: rng.randn(1, 4, 8, 512),
             4: rng.randn(1, 2, 4, 1024)}
    feats = {k: np.maximum(v, 0).astype(np.float32) for k, v in feats.items()}
    jc5 = jf.ResNet101C5Standard(dtype=jnp.float32)
    jneck = jf.FPNNeck(dtype=jnp.float32)
    c5_flat = _seeded(jax.eval_shape(lambda k: jc5.init(k, J(feats[4])),
                                     jax.random.PRNGKey(0))["params"], 2)
    c5_params = _unflatten(c5_flat)
    c5 = np.asarray(jc5.apply({"params": c5_params}, J(feats[4])))
    assert c5.shape == (1, 1, 2, 2048)
    jfeats = {**{k: J(v) for k, v in feats.items()}, 5: J(c5)}
    neck_flat = _seeded(jax.eval_shape(lambda k: jneck.init(k, jfeats),
                                       jax.random.PRNGKey(0))["params"], 3)
    want = jneck.apply({"params": _unflatten(neck_flat)}, jfeats)

    tc5, tneck = tf.ResNet101C5Standard(), tf.FPNNeck()
    tc5.load_state_dict(from_jax_params(c5_flat, tc5))
    tneck.load_state_dict(from_jax_params(neck_flat, tneck))
    nchw = {k: t(v).permute(0, 3, 1, 2) for k, v in feats.items()}
    with torch.no_grad():
        got_c5 = tc5(nchw[4])
        np.testing.assert_allclose(n(got_c5.permute(0, 2, 3, 1)), c5, rtol=0,
                                   atol=1e-4 * np.abs(c5).max())
        got = tneck({**nchw, 5: got_c5})
    assert set(got) == set(jf.FPN_STRIDES)
    for s in jf.FPN_STRIDES:
        w = np.asarray(want[s])
        np.testing.assert_allclose(n(got[s].permute(0, 2, 3, 1)), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=str(s))
    assert got[64].shape[-2:] == (1, 1) and got[4].shape[-2:] == (8, 16)


def test_resnet101c4_out_stages_are_the_trunks_own_maps():
    """ResNet101C4(out_stages=(2, 3, 4)) returns res2c, res3b3 and res4b22
    of the default trunk (a narrow run on a 64x96 s2d image, f32): the
    stage-4 map equal to the default output, each map equal to the units
    run one by one."""
    from relation_tpu_torch.models.backbone import ResNet101C4
    full = init_params(ResNet101C4(dtype=torch.float32), seed=3)
    pyr = ResNet101C4(dtype=torch.float32, out_stages=(2, 3, 4))
    pyr.load_state_dict(full.state_dict())
    x = t(np.random.RandomState(4).randn(1, 12, 32, 48).astype(np.float32) * 40)
    with torch.no_grad():
        outs = pyr(x)
        assert set(outs) == {2, 3, 4}
        assert torch.equal(outs[4], full(x))
        y = full.stem(x)
        for stage in (2, 3, 4):
            for u in full.units(stage):
                y = u(y)
            assert torch.equal(outs[stage], y), stage
    assert [v.shape[1] for v in outs.values()] == [256, 512, 1024]


@pytest.mark.parametrize("min_size", [0.0, 16.0])
def test_generate_proposals_fpn_matches_jax(min_size):
    """Seeded raw RPN outputs of five levels (16x24 .. 1x2 cells, A=3) on an
    image of 60x90 of the 64x96 bucket (cells past it masked), scale 1.5:
    the JAX function with topk="exact" and its while-loop NMS against the
    port's NMS path. rois, scores and real are equal (boxes to 1e-4 px:
    the decode is the same f32 arithmetic)."""
    rng = np.random.RandomState(int(min_size) + 5)
    A = 3
    shapes = {64: (1, 2), 32: (2, 3), 16: (4, 6), 8: (8, 12), 4: (16, 24)}
    rpn = {s: ((rng.randn(h, w, 2 * A) * 2).astype(np.float32),
               (rng.randn(h, w, 4 * A) * 0.3).astype(np.float32))
           for s, (h, w) in shapes.items()}
    im_info = np.asarray([60.0, 90.0, 1.5], np.float32)
    janchors = jf.fpn_anchors(shapes, (8,), (0.5, 1, 2))
    want = jf.generate_proposals_fpn({s: (J(c), J(b)) for s, (c, b) in rpn.items()},
                                     janchors, J(im_info), 200, 40, 0.7, min_size,
                                     use_kernel=False, topk="exact")
    from relation_tpu_torch.ops.anchors import generate_anchors
    base = {s: t(generate_anchors(s, (0.5, 1, 2), (8,)).astype(np.float32))
            for s in shapes}
    got = tf.generate_proposals_fpn({s: (t(c), t(b)) for s, (c, b) in rpn.items()},
                                    base, t(im_info), 200, 40, 0.7, min_size)
    np.testing.assert_array_equal(n(got[2]), np.asarray(want[2]))
    assert n(got[2]).sum() > 10
    np.testing.assert_allclose(n(got[0]), np.asarray(want[0]), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(n(got[1]), np.asarray(want[1]))


# --------------------------------------------------------------------------
# the head and the learned-NMS attention
# --------------------------------------------------------------------------

def test_pooled_head_with_relations_matches_jax():
    """The 4-level pooled head of the tiny fpn_relation model (synth_params,
    head width 64, two relation modules) on a seeded 256-channel pyramid of
    a 512x512 image and 40 ROIs spread over the four levels, 32 of them
    keys: cls_score, bbox_pred and fc2 within 1e-4."""
    cfg = family_cfg("fpn_relation")
    jm, params = jax_tiny_family(cfg)
    model = port_model(cfg, params)
    rng = np.random.RandomState(7)
    pyramid = {s: rng.randn(512 // s, 512 // s, 256).astype(np.float32)
               for s in jf.DISPATCH_STRIDES}
    rois = np.concatenate([_boxes(rng, 36, lo=8.0, hi=400.0, size=500.0),
                           _boxes(rng, 4, lo=460.0, hi=500.0, size=20.0)])
    fid = np.asarray(jf.roi_level_dispatch(J(rois)))
    assert set(np.unique(fid)) == {0, 1, 2, 3}
    want = jm.apply({"params": params}, {s: J(v) for s, v in pyramid.items()},
                    J(rois), 32, method=jf.RelationRCNNFPN.head)
    with torch.no_grad():
        got = model.head({s: t(v) for s, v in pyramid.items()}, t(rois), 32)
    for g, w, name in zip(got, want, ("cls_score", "bbox_pred", "fc2")):
        np.testing.assert_allclose(n(g), np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("case", ["dense", "dense_many_active", "compact"])
def test_nms_relation_module_xla_branch_matches_jax(case):
    """NMSRelationModule with allow_pallas=False, C=8 fg classes, N=13,
    NMS_COMPACT_CLASSES=2, against the JAX module with geom_emb_dtype=None:
    no class filter (dense: geometric bias + bias attention over every
    class); 5 active (> 2: dense); 2 active (compact: the skip forms over
    the active classes). Active classes within 1e-4; the JAX compact path
    also computes the inactive classes it pads its batch with, the port
    does not, and the learned-NMS head masks them."""
    from relation_tpu.models.relation import NMSRelationModule as JNMS
    from relation_tpu_torch.models.relation import NMSRelationModule
    rng = np.random.RandomState({"dense": 0, "dense_many_active": 1,
                                 "compact": 2}[case])
    C, N = 8, 13
    feat = rng.randn(N, C, 128).astype(np.float32)
    boxes = np.stack([_boxes(rng, N, size=300.0) for _ in range(C)], 1)
    from relation_tpu.ops.embeddings import extract_multi_position_matrix_t as jpos
    pos = np.asarray(jpos(J(boxes)))
    active = None
    if case != "dense":
        active = np.zeros(C, np.int32)
        active[rng.choice(C, 5 if case == "dense_many_active" else 2,
                          replace=False)] = 1
    jmod = JNMS(index=1, groups=16, dim_qk=1024, dim_out=128, allow_pallas=False,
                geom_emb_dtype=None, compact_classes=2)
    flat = _seeded(jax.eval_shape(lambda k: jmod.init(k, J(feat), J(pos)),
                                  jax.random.PRNGKey(0))["params"], 9)
    flat["nms_pair_pos_fc1_1/bias"] += 0.5          # most pairs clear of the clamp
    want, _ = jmod.apply({"params": _unflatten(flat)}, J(feat), J(pos),
                         active=None if active is None else J(active))
    mod = NMSRelationModule(1, 128, allow_pallas=False, compact_classes=2)
    mod.load_state_dict(from_jax_params(flat, mod))
    s0, b0 = tgb.skip_launches, tba.skip_launches
    with torch.no_grad():
        got = mod(t(feat), t(pos), None if active is None else t(active))
    want = np.asarray(want)
    on = np.ones(C, bool) if active is None else active.astype(bool)
    tol = 1e-4 * max(1.0, np.abs(want[:, on]).max())
    np.testing.assert_allclose(n(got)[:, on], want[:, on], rtol=0, atol=tol)
    # the CPU takes the plain versions: no launch counted
    assert (tgb.skip_launches, tba.skip_launches) == (s0, b0)


def _bias_case(rng, C, N, G=16, D=64, F=128, E=8):
    from relation_tpu.ops.embeddings import extract_multi_position_matrix_t as jpos
    boxes = np.stack([_boxes(rng, N, size=300.0) for _ in range(C)], 1)
    pos = np.asarray(jpos(J(boxes)))
    wg = (rng.randn(64, G) * 0.1).astype(np.float32)
    bg = (rng.randn(G) * 0.05 + 0.3).astype(np.float32)
    q, k = ((rng.randn(C, N, G * D) * 0.5).astype(np.float32) for _ in range(2))
    v = rng.randn(C, N, F).astype(np.float32)
    wl = (rng.randn(G, F, E) * 0.1).astype(np.float32)
    active = np.zeros(C, np.int32)
    active[[0, 2]] = 1
    return pos, wg, bg, q, k, v, wl, active


def test_plain_skip_and_bias_attention_match_pallas():
    """C=4, N=12, 2 of 4 classes active. fused_geometric_bias_skip: the
    plain version against the jnp reference at 1e-4 in the acc domain, and
    against the Pallas kernel (interpret mode) in the band of
    tests/test_torch_kernels_plain.py (its polynomial sin/cos); active rows
    only. fused_bias_attention and _skip (interpret mode on the CPU) on the
    same bias: active rows within 1e-4 of the largest element; the plain
    skip rows of inactive classes are zero, and the public wrappers take the
    plain versions for CPU tensors."""
    from relation_tpu.ops.pallas import geom_bias as jgb, nms_attention as jna
    rng = np.random.RandomState(11)
    pos, wg, bg, q, k, v, wl, active = _bias_case(rng, 4, 12)
    on = active.astype(bool)
    got = n(tgb.geom_bias_skip_reference(t(pos), t(wg), t(bg), t(active)))
    want = np.asarray(jgb.geom_bias_reference(J(pos), J(wg), J(bg)))
    pallas = np.asarray(jgb.fused_geometric_bias_skip(J(pos), J(wg), J(bg),
                                                      J(active), interpret=True))
    np.testing.assert_allclose(np.exp(got[on]), np.exp(want[on]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.exp(got[on]), np.exp(pallas[on]), rtol=5e-3, atol=2e-3)
    assert not got[~on].any()
    np.testing.assert_array_equal(
        n(tgb.fused_geometric_bias_skip(t(pos), t(wg), t(bg), t(active))), got)

    bias = want
    args = [J(a) for a in (bias, q, k, v, wl)]
    full = np.asarray(jna.fused_bias_attention(*args))
    skip = np.asarray(jna.fused_bias_attention_skip(*args, J(active)))
    ref = n(tba.bias_attention_reference(*(t(a) for a in (bias, q, k, v, wl))))
    tol = 1e-4 * max(1.0, np.abs(ref).max())
    np.testing.assert_allclose(ref, full, rtol=0, atol=tol)
    got_skip = n(tba.fused_bias_attention_skip(*(t(a) for a in (bias, q, k, v, wl)),
                                               t(active)))
    np.testing.assert_allclose(got_skip[on], skip[on], rtol=0, atol=tol)
    assert not got_skip[~on].any()
    np.testing.assert_array_equal(
        n(tba.fused_bias_attention(*(t(a) for a in (bias, q, k, v, wl)))), ref)


def test_bias_attention_gradient_matches_jax_vjp():
    """Row 7's gradient: autograd of the port's plain version (what the CUDA
    form's backward runs) against jax.vjp of the Pallas kernel's custom VJP,
    for all five inputs, within 1e-5 of each gradient's largest element."""
    from relation_tpu.ops.pallas import nms_attention as jna
    rng = np.random.RandomState(12)
    pos, wg, bg, q, k, v, wl, _ = _bias_case(rng, 3, 10)
    from relation_tpu.ops.pallas.geom_bias import geom_bias_reference
    bias = np.asarray(geom_bias_reference(J(pos), J(wg), J(bg)))
    cot = rng.randn(3, 10, 128).astype(np.float32)
    ins = (bias, q, k, v, wl)
    _, vjp = jax.vjp(jna.fused_bias_attention, *(J(a) for a in ins))
    want = vjp(J(cot))
    leaves = [t(a).requires_grad_(True) for a in ins]
    got = torch.autograd.grad(tba.fused_bias_attention(*leaves), leaves, t(cot))
    for g, w, name in zip(got, want, ("bias", "q", "k", "v", "wl")):
        w = np.asarray(w)
        np.testing.assert_allclose(n(g), w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


# --------------------------------------------------------------------------
# the whole slice: goldens, split forms, entry, conversion
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def learn_nms_setup():
    cfg = family_cfg("fpn_learn_nms")
    _, params = jax_tiny_family(cfg)
    return cfg, params, port_model(cfg, params)


@pytest.mark.parametrize("family", ["fpn", "fpn_relation", "fpn_learn_nms"])
def test_golden_detections(family, learn_nms_setup):
    """The committed goldens of the three FPN families (the JAX single-module
    predict with TPU.FPN_ALLOW_PALLAS False: the XLA learned-NMS branch),
    from synth_params carried across by from_jax_params, through the port's
    make_predict_fn, in the bands of the C4 goldens."""
    cfg = family_cfg(family)
    if family == "fpn_learn_nms":
        _, _, model = learn_nms_setup
    else:
        model = port_model(cfg, jax_tiny_family(cfg)[1])
    assert isinstance(model, tf.RelationRCNNFPN)
    assert model.use_relation == (family != "fpn")
    img, im_info = _fixed_input()
    out = make_predict_fn(model, cfg)(t(img), t(im_info))
    want = _load_fixture(family)
    assert (want[:, 1] > 0).any()
    _check_dets(n(out["dets"]), want)
    assert set(out["feat"]) == set(jf.FPN_STRIDES)


def test_split_predicts_match_the_single_module(learn_nms_setup):
    """The split and split3 forms (TPU.FPN_SPLIT_PREDICT True and 3 through
    build_predict_fn: the tail on allow_pallas=True) against the single
    module (the two-stage tail), as tests/test_fpn.py holds them in JAX:
    class ids equal, scores within 1e-4 (rtol) + 1e-5, boxes within 1e-4 +
    1e-4 rtol, rois equal; at the default class threshold and with a
    threshold that leaves one class active (the skip kernel of the split
    tail)."""
    cfg, _, model = learn_nms_setup
    img, im_info = _fixed_input()
    for th in (float(cfg.TEST.LEARN_NMS_CLASS_SCORE_TH), 0.5):
        c = cfg.copy()
        c.TEST.LEARN_NMS_CLASS_SCORE_TH = th
        ref = make_predict_fn(model, c)(t(img), t(im_info))
        d_ref = n(ref["dets"])
        assert (d_ref[:, 0] >= 0).any()
        for split in (True, 3):
            c.TPU.FPN_SPLIT_PREDICT = split
            got = build_predict_fn(model, c)(t(img), t(im_info))
            d = n(got["dets"])
            np.testing.assert_array_equal(d[:, 0], d_ref[:, 0])
            np.testing.assert_allclose(d[:, 1], d_ref[:, 1], rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(d[:, 2:], d_ref[:, 2:], rtol=1e-4, atol=1e-4)
            np.testing.assert_array_equal(n(got["rois"]), n(ref["rois"]))


def test_entry_and_build_predict_fn_dispatch():
    """build_predict_fn follows TPU.FPN_SPLIT_PREDICT for the FPN learned-NMS
    family only (True, 1, "2": split; 3: split3; False: single module; the
    other families: single module), and entry("fpn_learn_nms") serves the
    full-width model through it on the CPU when asked (built, not run); the
    split forms refuse a model they do not apply to, and so does the tail
    override on a C4 model; make_train_step builds the FPN step and runs it."""
    from relation_tpu_torch.core import predictor as P
    from relation_tpu_torch.core.trainer import build_model, make_train_step
    from relation_tpu_torch.entry import entry, family_cfg as port_family_cfg
    calls = []
    real = P.make_predict_fn

    def spy(model, cfg, tail_allow_pallas=None):
        calls.append(tail_allow_pallas)
        return real(model, cfg, tail_allow_pallas)
    cfg = family_cfg("fpn_learn_nms")
    model = build_model(cfg, tiny=True, device="cpu")
    try:
        P.make_predict_fn = spy
        for split, want in ((True, True), (1, True), ("2", True), (3, True),
                            (False, None), (0, None)):
            cfg.TPU.FPN_SPLIT_PREDICT = split
            build_predict_fn(model, cfg)
            assert calls.pop() is want, split
        cfg.TPU.FPN_SPLIT_PREDICT = True
        for fam in ("fpn", "fpn_relation"):
            c = family_cfg(fam)
            c.TPU.FPN_SPLIT_PREDICT = True
            build_predict_fn(build_model(c, tiny=True, device="cpu"), c)
            assert calls.pop() is None
        predict, (image, im_info) = entry("fpn_learn_nms", device="cpu",
                                          cfg=port_family_cfg("fpn_learn_nms",
                                                              tiny_shapes=True))
        assert calls.pop() is True and not calls
    finally:
        P.make_predict_fn = real
    assert isinstance(predict.model, tf.RelationRCNNFPN)
    assert isinstance(predict.model.c5, tf.ResNet101C5Standard)
    assert image.shape == (12, 304, 512) and image.device.type == "cpu"
    with pytest.raises(ValueError):
        make_predict_fn_split(build_model(family_cfg("fpn"), tiny=True,
                                          device="cpu"), family_cfg("fpn"))
    c4_cfg = port_family_cfg("dcn_learn_nms", tiny_shapes=True)
    with pytest.raises(ValueError, match="FPN model only"):
        make_predict_fn(build_model(c4_cfg, tiny=True, device="cpu"), c4_cfg,
                        tail_allow_pallas=True)
    # the FPN step builds and runs (tests/test_torch_fpn_train.py holds it
    # to the JAX step)
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.trainer import create_train_state
    from tests.test_golden_train import _fixed_batch
    init_params(model, seed=3)
    state, m = make_train_step(model, cfg, device="cpu")(
        create_train_state(model, cfg), _fixed_batch())
    assert state.step == 1 and np.isfinite(float(m["total_loss"]))


def test_convert_round_trip_and_init_params_on_the_fpn_tree():
    """Every leaf of the full-width fpn_learn_nms flax tree (jax.eval_shape)
    lands on one key of the port's state_dict with its shape, and
    to_jax_params gives the tree back leaf for leaf; init_params is
    deterministic and fills the neck and the roi_pool FCs at the flax
    initialisers' scales (normal(0.01) kernels, zero biases)."""
    from relation_tpu.core.trainer import build_model as j_build
    from relation_tpu_torch.core.trainer import build_model
    from relation_tpu_torch.entry import family_cfg as port_family_cfg
    cfg = port_family_cfg("fpn_learn_nms")
    jm = j_build(cfg)
    n0 = int(cfg.TEST.FIRST_N) + 1
    shapes = jax.eval_shape(
        lambda k: jm.init(k, jnp.zeros((12, 64, 64)), jnp.zeros((n0, 4)),
                          jnp.zeros((3,)), n0), jax.random.PRNGKey(0))["params"]
    from flax.traverse_util import flatten_dict
    flat = {k: np.broadcast_to(np.float32(0), v.shape)
            for k, v in flatten_dict(shapes, sep="/").items()}
    assert "neck/fpn_ft64_3x3/kernel" in flat and "c5/Bottleneck_0/res5a_branch1/kernel" in flat
    model = build_model(cfg, device="meta")
    sd = from_jax_params(flat, model)
    assert len(sd) == len(flat) == len(model.state_dict())
    assert sd["neck.fpn_ft4_1x1.weight"].shape == (256, 256, 1, 1)
    assert sd["roi_pool_fc1.weight"].shape == (1024, 7 * 7 * 256)
    back = to_jax_params(sd)
    assert set(back) == set(flat)
    assert all(back[k].shape == flat[k].shape for k in flat)

    tiny = family_cfg("fpn_learn_nms")
    a = init_params(build_model(tiny, tiny=True, device="cpu"), seed=1)
    b = init_params(build_model(tiny, tiny=True, device="cpu"), seed=1)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    w = a.neck.fpn_ft8_3x3.weight.detach()
    assert abs(float(w.std()) - 0.01) < 2e-3 and not a.neck.fpn_ft8_3x3.bias.any()
    assert abs(float(a.roi_pool_fc2.weight.detach().std()) - 0.01) < 2e-3


@pytest.mark.parametrize("family,yaml", [
    ("fpn", "rcnn_fpn_8epoch"), ("fpn_relation", "rcnn_fpn_relation_8epoch"),
    ("fpn_learn_nms", "rcnn_fpn_relation_learn_nms_8epoch")])
def test_family_cfg_follows_the_fpn_yaml(family, yaml):
    """entry.py::family_cfg against the FPN experiment YAML, read by the JAX
    package's loader: the symbol and every setting that shapes the model,
    the proposals or the detection tail (TEST.HAS_RPN excepted: the port's
    predict runs the RPN); and the model builds as the symbol says."""
    import os
    from relation_tpu.config.defaults import load_config
    from relation_tpu_torch.core.trainer import build_model
    from relation_tpu_torch.entry import family_cfg as port_family_cfg
    here = os.path.dirname(os.path.abspath(__file__))
    want = load_config(os.path.join(here, "..", "experiments", "cfgs",
                                    f"resnet_v1_101_coco_trainvalminus_{yaml}.yaml"))
    got = port_family_cfg(family)
    assert got.symbol == want.symbol and got.CLASS_AGNOSTIC == want.CLASS_AGNOSTIC
    for sec, keys in (("network", ("ANCHOR_SCALES", "ANCHOR_RATIOS", "NUM_ANCHORS",
                                   "FIXED_PARAMS", "NMS_TARGET_THRESH")),
                      ("dataset", ("NUM_CLASSES",)),
                      ("TRAIN", ("LEARN_NMS", "BATCH_ROIS", "ENABLE_OHEM",
                                 "BATCH_ROIS_OHEM", "FIRST_N", "lr", "RPN_MIN_SIZE",
                                 "RPN_PRE_NMS_TOP_N", "RPN_POST_NMS_TOP_N",
                                 "BBOX_NORMALIZATION_PRECOMPUTED")),
                      ("TEST", ("LEARN_NMS", "NMS", "SOFTNMS", "max_per_image",
                                "RPN_PRE_NMS_TOP_N", "RPN_POST_NMS_TOP_N",
                                "RPN_MIN_SIZE", "FIRST_N"))):
        for k in keys:
            a, b = got[sec][k], want[sec][k]
            assert (list(a) == list(b)) if isinstance(a, (list, tuple)) else a == b, \
                f"{sec}.{k}: {a} != {b}"
    if got.TEST.LEARN_NMS:
        assert got.TEST.LEARN_NMS_CLASS_SCORE_TH == want.TEST.LEARN_NMS_CLASS_SCORE_TH
    model = build_model(got, device="meta")
    assert isinstance(model, tf.RelationRCNNFPN)
    assert model.use_relation == ("attention" in got.symbol)
    assert model.use_learn_nms == bool(want.TEST.LEARN_NMS)
