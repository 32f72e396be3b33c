"""Port parity of the whole slice: flagship-symbol inference (C4 trunk, RPN,
proposals, relation head, learned NMS) at the tiny shape of
tests/test_golden_e2e.py::family_cfg("plain_learn_nms"), its synth_params
carried into relation_tpu_torch by from_jax_params, and _fixed_input().

Stages are held against the JAX path with its two Pallas kernels of this
path (geometric bias, skip attention) swapped for their jnp references:
those kernels' polynomial sin/cos differs from exact sin/cos by up to
~1e-3 in the bias (tests/test_torch_kernels_plain.py), more than the 1e-4
band. The final detections are also held against the unmodified JAX path
(Pallas kernels in interpret mode) and the committed golden fixture."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tests.test_torch_helpers import jax_tiny_family, n, port_model, t
from tests.test_golden_e2e import _fixed_input, _load_fixture, family_cfg
from relation_tpu.core.predictor import make_predict_fn as j_make_predict
from relation_tpu.models.detector import RelationRCNN as JRCNN
from relation_tpu_torch.core.predictor import make_predict_fn
from relation_tpu_torch.models.learn_nms import merge_multi_score

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def slice_setup():
    cfg = family_cfg("plain_learn_nms")
    jm, params = jax_tiny_family(cfg)
    return cfg, jm, params, port_model(cfg, params)


def _exact_trig_jax(monkeypatch):
    """Route the JAX model's Pallas kernels to their jnp references."""
    import relation_tpu.models.relation as jrel
    import relation_tpu.ops.pallas.geom_bias as jgb
    import relation_tpu.ops.pallas.nms_attention as jna

    def bias_ref(pos, k, b, scale=100.0):
        return jgb.geom_bias_reference(pos, k, b, scale)

    def skip_ref(pos, q, k, v, wg, bg, wl, active, scale=100.0):
        return jna.nms_relation_attention_reference(pos, q, k, v, wg, bg, wl,
                                                    scale)
    monkeypatch.setattr(jrel, "fused_geometric_bias", bias_ref)
    monkeypatch.setattr(jgb, "fused_geometric_bias", bias_ref)
    monkeypatch.setattr(jna, "fused_nms_relation_attention_skip", skip_ref)


def _jax_stages(jm, params, cfg, img, im_info, rois, cls_score, bbox_pred, fc2,
                class_thresh):
    """JAX stage outputs; head and learned NMS on the port's rois (the
    proposal stage is compared on its own)."""
    P = {"params": params}
    feat, rpn_cls, rpn_bbox = jm.apply(P, jnp.asarray(img),
                                       method=JRCNN.features_and_rpn)
    nongt = int(cfg.TEST.RPN_POST_NMS_TOP_N)
    cs, bp, f2 = jm.apply(P, feat, jnp.asarray(rois), nongt, method=JRCNN.head)
    ln = jm.apply(P, jnp.asarray(cls_score), jnp.asarray(bbox_pred),
                  jnp.asarray(rois), jnp.asarray(fc2), jnp.asarray(im_info),
                  class_thresh, method=JRCNN.learn_nms)
    return {"feat": feat, "rpn_cls": rpn_cls, "rpn_bbox": rpn_bbox,
            "cls_score": cs, "bbox_pred": bp, "fc2": f2, **ln}


def _threshold_for_skip(port_out, num_active):
    """A LEARN_NMS_CLASS_SCORE_TH that leaves exactly num_active classes."""
    m = np.sort(n(port_out["sorted_score"]).max(0))[::-1]
    return float((m[num_active - 1] + m[num_active]) / 2)


def _check_dets(got, want, box_tol=1e-2, score_tol=1e-4):
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0, atol=score_tol)
    np.testing.assert_allclose(got[:, 2:], want[:, 2:], rtol=0, atol=box_tol)


@pytest.mark.parametrize("branch", ["dense", "skip"])
def test_flagship_slice_matches_jax(slice_setup, monkeypatch, branch):
    cfg, jm, params, pm = slice_setup
    img, im_info = _fixed_input()
    cfg = cfg.copy()
    out = make_predict_fn(pm, cfg)(t(img), t(im_info))
    if branch == "skip":
        # at most C/2 active classes: relation.py:224 takes the skip kernel
        cfg.TEST.LEARN_NMS_CLASS_SCORE_TH = _threshold_for_skip(out, 2)
        out = make_predict_fn(pm, cfg)(t(img), t(im_info))
    c = pm.learn_nms_head.num_fg_classes
    active = n(out["sorted_score"]).max(0) >= min(
        cfg.TEST.LEARN_NMS_CLASS_SCORE_TH, n(out["sorted_score"]).max())
    assert (active.sum() <= c // 2) == (branch == "skip")

    # the unmodified JAX path (Pallas kernels in interpret mode): final dets
    j_out = j_make_predict(jm, cfg, (4, 4))(params, jnp.asarray(img),
                                           jnp.asarray(im_info))
    got = n(out["dets"])
    assert (got[:, 1] > 0).any()
    _check_dets(got, np.asarray(j_out["dets"]))
    np.testing.assert_allclose(n(out["rois"]), np.asarray(j_out["rois"]), **TOL)

    _exact_trig_jax(monkeypatch)
    j_exact = j_make_predict(jm, cfg, (4, 4))(params, jnp.asarray(img),
                                             jnp.asarray(im_info))
    np.testing.assert_allclose(n(out["rois"]), np.asarray(j_exact["rois"]), **TOL)
    np.testing.assert_allclose(n(out["roi_scores"]),
                               np.asarray(j_exact["roi_scores"]), **TOL)
    _check_dets(got, np.asarray(j_exact["dets"]))
    stages = _jax_stages(jm, params, cfg, img, im_info, n(out["rois"]),
                         n(out["cls_score"]), n(out["bbox_pred"]),
                         n(out["fc2"]), float(cfg.TEST.LEARN_NMS_CLASS_SCORE_TH))
    for name in ("feat", "rpn_cls", "rpn_bbox", "cls_score", "bbox_pred", "fc2",
                 "nms_multi_score", "sorted_bbox", "sorted_score"):
        np.testing.assert_allclose(n(out[name]), np.asarray(stages[name]),
                                   err_msg=name, **TOL)
    np.testing.assert_allclose(
        n(merge_multi_score(out["nms_multi_score"], -1)),
        np.asarray(stages["nms_multi_score"]).mean(2), **TOL)


def test_flagship_slice_matches_golden(slice_setup):
    """The committed plain_learn_nms golden (JAX, Pallas in interpret mode):
    same classes and order, boxes within 1e-2 px, scores within 1e-4."""
    cfg, _, _, pm = slice_setup
    img, im_info = _fixed_input()
    got = n(make_predict_fn(pm, cfg)(t(img), t(im_info))["dets"])
    want = _load_fixture("plain_learn_nms")
    assert (want[:, 1] > 0).any()
    _check_dets(got, want)


def test_from_jax_params_round_trips_flagship_shapes():
    """Every leaf of the full-width flagship's flax tree (jax.eval_shape, no
    compute) lands on exactly one key of the port's state_dict with its
    shape: no missing and no extra keys."""
    from relation_tpu.core.trainer import build_model as j_build
    from relation_tpu_torch.convert import from_jax_params
    from relation_tpu_torch.core.trainer import build_model
    from relation_tpu_torch.entry import flagship_cfg
    from __graft_entry__ import _flagship_cfg

    jcfg = _flagship_cfg()
    jm = j_build(jcfg)
    n0 = int(jcfg.TEST.FIRST_N) + 1
    shapes = jax.eval_shape(
        lambda k: jm.init(k, jnp.zeros((12, 304, 512)),
                          jnp.zeros((n0, 4)), jnp.zeros((3,)), n0),
        jax.random.PRNGKey(0))["params"]
    flat = {k: np.broadcast_to(np.float32(0), v.shape)
            for k, v in flat_numpy_shapes(shapes).items()}
    model = build_model(flagship_cfg(), device="meta")
    sd = from_jax_params(flat, model)
    assert len(sd) == len(flat) == len(model.state_dict())
    # a missing or an extra leaf raises
    with pytest.raises(KeyError):
        from_jax_params(dict(list(flat.items())[1:]), model)
    with pytest.raises(KeyError):
        from_jax_params({**flat, "extra/kernel": np.zeros((2, 2))}, model)


def flat_numpy_shapes(tree):
    from flax.traverse_util import flatten_dict
    return flatten_dict(tree, sep="/")


def test_build_model_policy_and_refusals():
    from relation_tpu_torch.core.trainer import build_model, resolve_device
    from relation_tpu_torch.entry import flagship_cfg
    cfg = flagship_cfg()
    model = build_model(cfg, device="meta")
    # f32 master weights; the trunk computes in bf16 (a cast at the call)
    assert model.c4.Bottleneck_0.res2a_branch2a.weight.dtype == torch.float32
    assert model.c4.Bottleneck_0.res2a_branch2a.compute_dtype == torch.bfloat16
    assert model.fc_new_1.compute_dtype == torch.float32
    assert model.learn_nms_head.nms_logit.weight.dtype == torch.float32
    cfg.TPU.COMPUTE_DTYPE = "float32"
    assert build_model(cfg, device="meta").c4.Bottleneck_0 \
        .res2a_branch2a.compute_dtype == torch.float32
    # the DCN symbols build: deformable res5 (f32 offset convs, a bare f32
    # deformable weight) and the offset FC, pooled in TPU.DCN_POOL_DTYPE
    from relation_tpu_torch.models.backbone import ResNet101C5DCN
    for sym in ("resnet_v1_101_dcn_rcnn",
                "resnet_v1_101_rcnn_dcn_attention_1024_pairwise_position_"
                "multi_head_16",
                "resnet_v1_101_dcn_attention_1024_pairwise_position_"
                "multi_head_16_learn_nms"):
        cfg.symbol = sym
        dcn = build_model(cfg, device="meta")
        assert dcn.dcn and isinstance(dcn.c5, ResNet101C5DCN)
        assert dcn.use_relation == ("attention" in sym)
        unit = dcn.c5.DCNBottleneck_0
        assert unit.res5a_branch2b_offset.weight.shape == (72, 512, 3, 3)
        assert not hasattr(unit.res5a_branch2b_offset, "compute_dtype")
        assert unit.res5a_branch2b_weight.dtype == torch.float32
        assert unit.res5a_branch2a.compute_dtype == torch.float32
        assert dcn.offset.weight.shape == (98, 7 * 7 * 256)
        assert dcn.dcn_pool_dtype == torch.bfloat16
    cfg.TPU.DCN_POOL_DTYPE = "float32"
    assert build_model(cfg, device="meta").dcn_pool_dtype == torch.float32
    assert build_model(cfg, tiny=True, device="meta").dcn_pool_dtype == torch.float32
    # the FPN symbols build: the pyramid trunk (res2..res4 maps, a standard
    # res5 at stride 32), the neck, the RPN on 256 channels and the 7x7x256
    # pooled head; the learned-NMS head on the two-stage attention branch
    # unless TPU.FPN_ALLOW_PALLAS says otherwise
    from relation_tpu_torch.models.fpn import (FPNNeck, RelationRCNNFPN,
                                               ResNet101C5Standard)
    cfg.TPU.FPN_ALLOW_PALLAS = False
    for sym in ("resnet_v1_101_rcnn_fpn",
                "resnet_v1_101_rcnn_fpn_attention_1024_pairwise_position_"
                "multi_head_16_learn_nms"):
        cfg.symbol = sym
        fpn = build_model(cfg, device="meta")
        assert isinstance(fpn, RelationRCNNFPN)
        assert fpn.c4.out_stages == (2, 3, 4)
        assert isinstance(fpn.c5, ResNet101C5Standard)
        assert isinstance(fpn.neck, FPNNeck)
        assert fpn.rpn.rpn_conv_3x3.weight.shape == (512, 256, 3, 3)
        assert fpn.roi_pool_fc1.weight.shape == (1024, 7 * 7 * 256)
        assert fpn.use_relation == ("attention" in sym)
        nms = fpn.learn_nms_head.NMSRelationModule_0
        assert not nms.allow_pallas and nms.compact_classes == 32
    cfg.TPU.FPN_ALLOW_PALLAS = "lnms"
    assert build_model(cfg, device="meta").learn_nms_head \
        .NMSRelationModule_0.allow_pallas
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


def test_init_params_is_deterministic_and_not_degenerate():
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.trainer import build_model
    cfg = family_cfg("plain_learn_nms")
    a = init_params(build_model(cfg, tiny=True, device="cpu"), seed=3)
    b = init_params(build_model(cfg, tiny=True, device="cpu"), seed=3)
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    sd = a.state_dict()
    assert torch.all(sd["learn_nms_head.nms_logit.bias"] == -3.0)
    w = sd["c4.tiny1.weight"]
    assert abs(float(w.std()) - (1 / (9 * 32)) ** 0.5) < 0.2 * (1 / (9 * 32)) ** 0.5
    assert abs(float(sd["fc_new_1.weight"].std()) - 0.01) < 1e-3
    img, im_info = _fixed_input()
    dets = n(make_predict_fn(a, cfg)(t(img), t(im_info))["dets"])
    assert np.isfinite(dets).all() and (dets[:, 1] > 0).any()
