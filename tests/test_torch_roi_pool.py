"""Port parity of exact ROIPooling and the gather-form ROIAlign
(relation_tpu_torch/ops/roi_pool.py, the plain version of
ops/kernels/roi_pool.py) against relation_tpu/ops/roi_pool.py, on the cases
of tests/test_roi_pool.py; then the C4 head and the FPN ``pool_pyramid`` with
``roi_method="pool"`` against the JAX package's. ROIPooling's values are
maxima of the inputs, so they are held bit-equal; its gradient is held where
the features have no ties (the JAX autodiff of ``max`` splits a tie, the
port gives it to the first maximum in scan order, as MXNet does)."""

import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from relation_tpu_torch.ops import roi_pool as trp
from relation_tpu_torch.ops.kernels import roi_pool as krp
from tests.reference_impls import np_roi_pool
from tests.test_golden_e2e import family_cfg
from tests.test_roi_pool import clipped_rois
from tests.test_torch_helpers import jax_tiny_family, n, port_model, t

J = jnp.asarray
# the module (relation_tpu.ops exports a function of the same name)
jrp = importlib.import_module("relation_tpu.ops.roi_pool")


def test_f32_div_is_correctly_rounded():
    """The bin size's division: the port divides two f32 tensors, which is
    IEEE-exact; every feature-map numerator against numpy's division and
    against the JAX package's integer emulation (tests/test_roi_pool.py's
    exhaustive cases). A multiplication by the reciprocal misses it."""
    num = np.arange(1, 4097, dtype=np.int32)
    for d in (1, 2, 3, 6, 7, 14):
        want = (num.astype(np.float32) / np.float32(d)).astype(np.float32)
        got = n(krp.f32_div(torch.from_numpy(num), d))
        np.testing.assert_array_equal(got, want, err_msg=f"d={d}")
        np.testing.assert_array_equal(got, np.asarray(jrp._f32_div_int(J(num), d)))
    recip = num.astype(np.float32) * np.float32(1.0 / 7)
    assert not np.array_equal(recip, num.astype(np.float32) / np.float32(7))


def _case(name):
    """(feat, rois, P) of tests/test_roi_pool.py's cases."""
    rng = np.random.RandomState(0)
    if name == "oracle":
        feat = rng.randn(38, 63, 8).astype(np.float32)
        return feat, clipped_rois(np.random.default_rng(0), 64, 38, 63), 7
    if name == "divisible":
        feat = rng.randn(38, 63, 4).astype(np.float32)
        rois = np.array([[592.23364, 259.00854, 1007.0, 573.4533],
                         [16.0, 16.0, 16 * 21.0, 16 * 21.0],
                         [0.0, 0.0, 16 * 7 - 8.0, 16 * 14 - 8.0]], np.float32)
        return feat, rois, 7
    if name == "tiny_degenerate":
        feat = rng.randn(16, 16, 4).astype(np.float32) + 10.0
        rois = np.array([[8.0, 8.0, 9.0, 9.0], [0.0, 0.0, 0.5, 0.5],
                         [8.0, 250.0, 40.0, 255.0],
                         [100.0, 100.0, 180.0, 180.0]], np.float32)
        return feat, rois, 7
    P = int(name[-1])
    feat = rng.randn(25, 40, 8).astype(np.float32)
    return feat, clipped_rois(np.random.default_rng(P), 32, 25, 40), P


@pytest.mark.parametrize("name", ["oracle", "divisible", "tiny_degenerate",
                                  "pooled_3", "pooled_7"])
def test_roi_pool_matches_jax_bit_for_bit(name):
    """The port's roi_pool, JAX's roi_pool and the MXNet oracle agree bit
    for bit; the degenerate case hits empty bins (zeros)."""
    feat, rois, P = _case(name)
    want = np_roi_pool(feat, rois, 1.0 / 16, P)
    jax_out = np.asarray(jrp.roi_pool(J(feat), J(rois), 1.0 / 16, P))
    got = n(trp.roi_pool(t(feat), t(rois), 1.0 / 16, P))
    np.testing.assert_array_equal(jax_out, want)
    np.testing.assert_array_equal(got, want)
    if name == "tiny_degenerate":
        assert (want == 0).any()
    # bf16 features: the maxima are the same elements
    got16 = trp.roi_pool(t(feat).bfloat16(), t(rois), 1.0 / 16, P)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        n(got16), n(trp.roi_pool(t(feat).bfloat16().float(), t(rois),
                                 1.0 / 16, P)))


def test_roi_pool_argmax_is_the_first_maximum_in_scan_order():
    """A bin of equal values: the argmax is its first cell (h, then w), as
    MXNet's strict '>' scan gives; empty bins give -1."""
    feat = torch.ones(8, 8, 2)
    rois = torch.tensor([[16.0, 32.0, 80.0, 96.0], [0.0, 0.0, 4.0, 4.0]])
    am = krp.roi_pool_argmax_reference(feat, rois, 1.0 / 16, 2)
    hs, _, ws, _ = krp.roi_pool_bins(rois, 1.0 / 16, 2, 8, 8)
    first = hs[0][:, None] * 8 + ws[0][None, :]
    assert torch.equal(am[0, :, :, 0], first) and torch.equal(am[0, ..., 1], first)
    assert (am[1] >= 0).sum() > 0 and ((am[1] == -1) | (am[1] == 0)).all()


def test_roi_pool_gradient_matches_jax():
    """The gradient of a random cotangent with respect to the feature map
    (no ties among the features) against jax.grad of JAX's roi_pool: within
    1e-5 relative, 1e-6 absolute (the same cotangents summed into a cell in
    another order); the CPU takes the plain version (no kernel launch)."""
    rng = np.random.RandomState(3)
    feat = rng.randn(19, 27, 6).astype(np.float32)
    rois = clipped_rois(np.random.default_rng(5), 24, 19, 27)
    cot = rng.randn(24, 7, 7, 6).astype(np.float32)
    want = jax.grad(lambda f: jnp.sum(jrp.roi_pool(f, J(rois), 1.0 / 16, 7)
                                      * J(cot)))(J(feat))
    f = t(feat).requires_grad_()
    before = krp.launches
    (trp.roi_pool(f, t(rois), 1.0 / 16, 7) * t(cot)).sum().backward()
    assert krp.launches == before
    np.testing.assert_allclose(n(f.grad), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert np.abs(n(f.grad)).max() > 0


@pytest.mark.parametrize("mode", ["avg", "max"])
def test_roi_align_gather_form_matches_jax(mode):
    """The gather-form ROIAlign against JAX's at 1e-5; its avg mode against
    the port's interpolation-matrix form at 2e-5 (the JAX test's band)."""
    rng = np.random.RandomState(4)
    feat = rng.randn(20, 24, 8).astype(np.float32)
    rois = clipped_rois(np.random.default_rng(3), 16, 20, 24)
    want = np.asarray(jrp.roi_align(J(feat), J(rois), 1.0 / 16, 7, mode=mode))
    got = n(trp.roi_align(t(feat), t(rois), 1.0 / 16, 7, mode=mode))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if mode == "avg":
        np.testing.assert_allclose(
            got, n(trp.roi_align_mxu(t(feat), t(rois), 1.0 / 16, 7)),
            rtol=2e-5, atol=2e-5)


def test_c4_head_with_roi_pool_matches_jax(monkeypatch):
    """The tiny plain_relation head with TPU.ROI_METHOD='pool' (the JAX
    model built from the same config, its params carried across with
    from_jax_params, its geometric bias on the jnp reference as in
    tests/test_torch_flagship.py) on a seeded 256-channel map of a 512x512
    image and 40 clipped ROIs, 32 of them keys: the pooled features
    bit-equal, cls_score, bbox_pred and fc2 within 1e-4; the align model's
    pooled features differ."""
    import relation_tpu.models.relation as jrel
    import relation_tpu.ops.pallas.geom_bias as jgb
    from relation_tpu.models.detector import RelationRCNN as JRCNN
    monkeypatch.setattr(jrel, "fused_geometric_bias",
                        lambda pos, k, b, scale=100.0:
                        jgb.geom_bias_reference(pos, k, b, scale))
    cfg = family_cfg("plain_relation")
    cfg.TPU.ROI_METHOD = "pool"
    jm, params = jax_tiny_family(cfg)
    model = port_model(cfg, params)
    assert model.roi_method == "pool"
    rng = np.random.RandomState(11)
    feat = rng.randn(32, 32, 256).astype(np.float32)
    rois = clipped_rois(np.random.default_rng(11), 40, 32, 32)
    want = jm.apply({"params": params}, J(feat), J(rois), 32, method=JRCNN.head)
    j_flat = jm.apply({"params": params}, J(feat), J(rois), 32, pool_only=True,
                      method=JRCNN.head)
    with torch.no_grad():
        got = model.head(t(feat), t(rois), 32)
        flat = model.head(t(feat), t(rois), 32, pool_only=True)
    np.testing.assert_array_equal(n(flat), np.asarray(j_flat))
    for g, w, name in zip(got, want, ("cls_score", "bbox_pred", "fc2")):
        np.testing.assert_allclose(n(g), np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    model.roi_method = "align"
    with torch.no_grad():
        assert not torch.equal(model.head(t(feat), t(rois), 32, pool_only=True),
                               flat)


def test_pool_pyramid_with_roi_pool_matches_jax():
    """pool_pyramid(roi_method='pool') (each ROI pooled at its dispatch
    level) against the JAX FPN head's selection of roi_pool at the four
    levels: values bit-equal, the gradient with respect to each level
    within 1e-6; then the tiny fpn_relation head built with
    TPU.ROI_METHOD='pool' against JAX's within 1e-4."""
    from relation_tpu.models import fpn as jf
    from relation_tpu_torch.models.fpn import DISPATCH_STRIDES, pool_pyramid
    rng = np.random.RandomState(0)
    size = 512
    pyr = {s: rng.randn(size // s, size // s, 8).astype(np.float32)
           for s in DISPATCH_STRIDES}
    wh = np.array([[30, 40], [300, 280], [230, 200], [60, 80], [10, 14],
                   [500, 420], [120, 150], [20, 20]], np.float32)
    xy = rng.uniform(0, 6, (len(wh), 2)).astype(np.float32)
    rois = np.concatenate([xy, xy + wh - 1], 1)
    cot = rng.randn(len(rois), 7, 7, 8).astype(np.float32)

    def j_pool(levels):
        parts = jnp.stack([jrp.roi_pool(levels[s], J(rois), 1.0 / s, 7)
                           for s in jf.DISPATCH_STRIDES])
        sel = jax.nn.one_hot(jf.roi_level_dispatch(J(rois)), 4,
                             dtype=jnp.float32, axis=0)
        return jnp.einsum("lnpqc,ln->npqc", parts, sel)
    jl = {s: J(v) for s, v in pyr.items()}
    want = np.asarray(j_pool(jl))
    j_grad = jax.grad(lambda lv: jnp.sum(j_pool(lv) * J(cot)))(jl)
    levels = {s: t(v).requires_grad_() for s, v in pyr.items()}
    got = pool_pyramid(levels, t(rois), roi_method="pool")
    np.testing.assert_array_equal(n(got), want)
    (got * t(cot)).sum().backward()
    for s in DISPATCH_STRIDES:
        np.testing.assert_allclose(n(levels[s].grad), np.asarray(j_grad[s]),
                                   rtol=0, atol=1e-6, err_msg=f"stride {s}")

    from relation_tpu.models.fpn import RelationRCNNFPN as JFPN
    cfg = family_cfg("fpn_relation")
    cfg.TPU.ROI_METHOD = "pool"
    jm, params = jax_tiny_family(cfg)
    model = port_model(cfg, params)
    pyr = {s: rng.randn(size // s, size // s, 256).astype(np.float32)
           for s in DISPATCH_STRIDES}
    rois = clipped_rois(np.random.default_rng(2), 40, 32, 32)
    want = jm.apply({"params": params}, {s: J(v) for s, v in pyr.items()},
                    J(rois), 32, method=JFPN.head)
    with torch.no_grad():
        got = model.head({s: t(v) for s, v in pyr.items()}, t(rois), 32)
    for g, w, name in zip(got, want, ("cls_score", "bbox_pred", "fc2")):
        np.testing.assert_allclose(n(g), np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_roi_method_is_checked():
    """An unknown TPU.ROI_METHOD is refused by both detectors."""
    from relation_tpu_torch.core.trainer import build_model
    for family in ("plain_relation", "fpn_relation"):
        cfg = family_cfg(family)
        cfg.TPU.ROI_METHOD = "bilinear"
        with pytest.raises(ValueError, match="roi_method"):
            build_model(cfg, tiny=True, device="cpu")
