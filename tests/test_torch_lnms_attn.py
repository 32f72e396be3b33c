"""TPU.LNMS_ATTN on a C4 model: "xla" sends the port's learned-NMS head
through the XLA branch of NMSRelationModule (compact at most
TPU.NMS_COMPACT_CLASSES active classes, dense above), as the JAX build_model
does; "pallas" (the default) keeps the skip-kernel dispatch. The tiny
plain_learn_nms model (4 foreground classes) with NMS_COMPACT_CLASSES = 2,
the same numpy parameters in both packages; the JAX learned-NMS stage runs
on the port's head outputs."""

import numpy as np
import pytest
import jax.numpy as jnp

import relation_tpu_torch.models.relation as prel
from tests.test_golden_e2e import _fixed_input, family_cfg
from tests.test_torch_helpers import jax_tiny_family, n, port_model, t
from relation_tpu.models.detector import RelationRCNN as JRCNN
from relation_tpu_torch.core.predictor import make_predict_fn

# f32 on the CPU in both packages, sums in other orders
TOL = dict(rtol=1e-4, atol=1e-4)
BRANCH_FNS = ("fused_geometric_bias", "fused_geometric_bias_skip",
              "fused_bias_attention", "fused_bias_attention_skip",
              "fused_nms_relation_attention_skip")


def _threshold(sorted_score, num_active):
    """A LEARN_NMS_CLASS_SCORE_TH that leaves exactly num_active classes."""
    m = np.sort(n(sorted_score).max(0))[::-1]
    return float((m[num_active - 1] + m[num_active]) / 2)


@pytest.fixture(scope="module")
def models():
    """attn -> (cfg, JAX model, params, port model), built once each."""
    built = {}

    def get(attn):
        if attn not in built:
            cfg = family_cfg("plain_learn_nms")
            cfg.TPU.LNMS_ATTN = attn
            cfg.TPU.NMS_COMPACT_CLASSES = 2
            jm, params = jax_tiny_family(cfg)
            built[attn] = (cfg, jm, params, port_model(cfg, params))
        return built[attn]
    return get


@pytest.mark.parametrize("attn,num_active,called", [
    ("xla", 3, {"fused_geometric_bias", "fused_bias_attention"}),
    ("xla", 2, {"fused_geometric_bias_skip", "fused_bias_attention_skip"}),
    ("pallas", 2, {"fused_nms_relation_attention_skip"})])
def test_c4_learned_nms_follows_lnms_attn(models, monkeypatch, attn, num_active,
                                          called):
    cfg, jm, params, pm = models(attn)
    cfg = cfg.copy()
    cfg.TEST = cfg.TEST.copy()
    assert jm.lnms_allow_pallas == (attn == "pallas") and jm.compact_classes == 2
    mod = pm.learn_nms_head.NMSRelationModule_0
    assert mod.allow_pallas == (attn == "pallas") and mod.compact_classes == 2

    img, im_info = _fixed_input()
    first = make_predict_fn(pm, cfg)(t(img), t(im_info))
    cfg.TEST.LEARN_NMS_CLASS_SCORE_TH = _threshold(first["sorted_score"],
                                                   num_active)
    # the kernels the learned-NMS attention calls (the head's relation
    # modules call the geometric bias too)
    calls, inside = [], []
    for name in BRANCH_FNS:
        fn = getattr(prel, name)
        monkeypatch.setattr(prel, name, lambda *a, _f=fn, _n=name, **k: (
            inside and calls.append(_n), _f(*a, **k))[1])
    forward = mod.forward

    def traced(*a, **k):
        inside.append(1)
        try:
            return forward(*a, **k)
        finally:
            inside.pop()
    monkeypatch.setattr(mod, "forward", traced)
    out = make_predict_fn(pm, cfg)(t(img), t(im_info))
    assert set(calls) == called, calls

    active = n(out["sorted_score"]).max(0) >= cfg.TEST.LEARN_NMS_CLASS_SCORE_TH
    assert active.sum() == num_active
    want = jm.apply({"params": params}, jnp.asarray(n(out["cls_score"])),
                    jnp.asarray(n(out["bbox_pred"])), jnp.asarray(n(out["rois"])),
                    jnp.asarray(n(out["fc2"])), jnp.asarray(im_info),
                    float(cfg.TEST.LEARN_NMS_CLASS_SCORE_TH), method=JRCNN.learn_nms)
    for name in ("sorted_score", "sorted_bbox"):
        np.testing.assert_allclose(n(out[name]), np.asarray(want[name]),
                                   err_msg=name, **TOL)
    # the rows of the active classes (the skip forms leave the others to the
    # head's mask; the JAX compact path computes padding classes)
    np.testing.assert_allclose(n(out["nms_multi_score"])[:, active],
                               np.asarray(want["nms_multi_score"])[:, active],
                               **TOL)
