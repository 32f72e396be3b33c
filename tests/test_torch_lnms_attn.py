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


# HEAD_DTYPE="bfloat16": JAX's dense attention (_dense_attention_impl) runs
# its einsums in q.dtype. The port rounds the same operands to bf16 (q and k,
# the values, linear_out), runs its f32 kernels on them and rounds the output
# to bf16, as JAX's last einsum returns it. Left: JAX's bf16 rounding of the
# scores, the attention and attn @ v inside the path. Bands, at seed 0:
# - max: 1e-2 of the largest element (measured 3.8e-3 on each route);
# - mean: 0.65 of JAX's own bf16-vs-f32 mean spread. The port reads 0.48 to
#   0.54 of it on the three routes; before the repair (every branch in f32 on
#   the bf16 q and k) it read 0.72 to 0.78, which the test asserts as a
#   failure of the band. Over seeds 0-3 the repaired port reads 0.48 to
#   0.57.
BF16_BAND, BF16_MEAN_BAND = 1e-2, 0.65


def _nms_module_case(seed=0, C=4, N=12, F=32, G=4, DQK=32, DOUT=16):
    """One seeded narrow learned-NMS attention: roi_feat [N, C, F], the
    per-class geometry [C, 4, N, N] and the module's flax parameters."""
    from relation_tpu_torch.ops.embeddings import extract_multi_position_matrix_t
    rng = np.random.RandomState(seed)

    def boxes():
        c = rng.uniform(20, 200, (N, 2))
        wh = rng.uniform(10, 60, (N, 2))
        return np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)

    def r(*shape, s=1.0, o=0.0):
        return (rng.randn(*shape) * s + o).astype(np.float32)
    pos = n(extract_multi_position_matrix_t(t(np.stack([boxes() for _ in range(C)], 1))))
    params = {
        "nms_query_1": {"kernel": r(F, DQK, s=F ** -0.5), "bias": r(DQK, s=0.1)},
        "nms_key_1": {"kernel": r(F, DQK, s=F ** -0.5), "bias": r(DQK, s=0.1)},
        "nms_pair_pos_fc1_1": {"kernel": r(64, G, s=0.1), "bias": r(G, s=0.05, o=0.5)},
        "nms_linear_out_1_weight": r(G, F, DOUT // G, s=0.1),
        "nms_linear_out_1_bias": r(DOUT, s=0.1)}
    return r(N, C, F), pos, params, (F, G, DQK, DOUT)


def _unrepaired_f32_port(pm, feat, pos, act):
    """The port's learned-NMS attention as it stood before the bf16 repair:
    every branch in f32 on the module's bf16 q and k (the values, linear_out
    and the output unrounded)."""
    import torch
    from relation_tpu_torch.ops.kernels import bias_attention as BA
    from relation_tpu_torch.ops.kernels import geom_bias as GB
    f = t(feat).transpose(0, 1)                                  # [C, N, F]
    q, k = pm.nms_query_1(f).float(), pm.nms_key_1(f).float()
    pp = pm.nms_pair_pos_fc1_1
    wg, bg = pp.weight.t(), pp.bias
    wl = pm.nms_linear_out_1_weight
    if act is None:
        y = BA.fused_bias_attention(GB.fused_geometric_bias(t(pos), wg, bg), q, k, f, wl)
    else:
        a = torch.tensor(act)
        y = BA.fused_bias_attention_skip(
            GB.fused_geometric_bias_skip(t(pos), wg, bg, a), q, k, f, wl, a)
    return n((y + pm.nms_linear_out_1_bias).transpose(0, 1))


@pytest.mark.parametrize("allow_pallas,active", [
    (True, None), (False, None), (False, (1, 0, 1, 0))])
def test_nms_attention_head_dtype_bf16_follows_jax(allow_pallas, active):
    """NMSRelationModule with dtype bf16 on the three routes of JAX's
    _dense_attention_impl (the Pallas dense route, XLA dense and XLA compact
    with 2 of 4 classes active): the port against JAX in bf16 within the bf16
    bands (active rows), where the port before the repair misses the mean
    band; and on the XLA routes in f32 within the f32 band (the Pallas
    geometric bias's trig is a standing difference of ~2e-3)."""
    import torch
    from relation_tpu.models.relation import NMSRelationModule as JNMS
    from relation_tpu_torch.models.relation import NMSRelationModule as PNMS
    feat, pos, p, (F, G, DQK, DOUT) = _nms_module_case()
    act = None if active is None else np.asarray(active, np.int32)
    rows = slice(None) if act is None else act.astype(bool)
    sd = {"nms_query_1.weight": p["nms_query_1"]["kernel"].T,
          "nms_query_1.bias": p["nms_query_1"]["bias"],
          "nms_key_1.weight": p["nms_key_1"]["kernel"].T,
          "nms_key_1.bias": p["nms_key_1"]["bias"],
          "nms_pair_pos_fc1_1.weight": p["nms_pair_pos_fc1_1"]["kernel"].T,
          "nms_pair_pos_fc1_1.bias": p["nms_pair_pos_fc1_1"]["bias"],
          "nms_linear_out_1_weight": p["nms_linear_out_1_weight"],
          "nms_linear_out_1_bias": p["nms_linear_out_1_bias"]}
    want, ports = {}, {}
    for jdt, pdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        jm = JNMS(index=1, groups=G, dim_qk=DQK, dim_out=DOUT, dtype=jdt,
                  allow_pallas=allow_pallas, compact_classes=2)
        want[jdt] = np.asarray(jm.apply(
            {"params": p}, jnp.asarray(feat), jnp.asarray(pos),
            None if act is None else jnp.asarray(act))[0])[:, rows]
        pm = PNMS(1, F, DQK, DOUT, G, dtype=pdt, allow_pallas=allow_pallas,
                  compact_classes=2)
        pm.load_state_dict({k: t(np.ascontiguousarray(v)) for k, v in sd.items()})
        with torch.no_grad():
            got = n(pm(t(feat), t(pos), None if act is None else torch.tensor(act)))
            ports[jdt] = (pm, got[:, rows])
    if not allow_pallas:
        np.testing.assert_allclose(ports[jnp.float32][1], want[jnp.float32], **TOL)
    ref = want[jnp.bfloat16]
    spread = np.abs(want[jnp.float32] - ref).mean()
    got = ports[jnp.bfloat16][1]
    assert np.abs(got - ref).max() <= BF16_BAND * np.abs(ref).max()
    assert np.abs(got - ref).mean() <= BF16_MEAN_BAND * spread
    with torch.no_grad():
        before = _unrepaired_f32_port(ports[jnp.bfloat16][0], feat, pos, act)[:, rows]
    assert np.abs(before - ref).mean() > BF16_MEAN_BAND * spread
