"""Port parity: the ops of relation_tpu_torch against relation_tpu, same
numpy inputs, f32 at rtol=atol=1e-5; NMS keep masks and proposal indices
exactly equal."""

import numpy as np
import pytest
import jax.numpy as jnp

from tests.test_torch_helpers import n, t
from relation_tpu.ops import anchors as ja, boxes as jb, embeddings as je, nms as jn
from relation_tpu.ops.roi_pool import roi_align_mxu as j_roi_align_mxu
from relation_tpu_torch.ops import (anchors as ta, boxes as tb, embeddings as te,
                                    nms as tn, roi_pool as tr)

TOL = dict(rtol=1e-5, atol=1e-5)


def _boxes(rng, k, lo=0.0, hi=200.0):
    xy = rng.uniform(lo, hi, (k, 2))
    wh = rng.uniform(2, 80, (k, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_config_and_attrdict_match():
    from relation_tpu.config.defaults import default_config as jcfg
    from relation_tpu_torch.config.defaults import default_config as tcfg

    def flat(d, p=""):
        out = {}
        for k, v in d.items():
            out.update(flat(v, p + k + ".") if isinstance(v, dict)
                       else {p + k: v})
        return out
    a, b = flat(jcfg()), flat(tcfg())
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k], object),
                                      np.asarray(b[k], object), err_msg=k)
    c = tcfg()
    c.TEST.NEW = {"x": 1}
    assert c.TEST.NEW.x == 1 and c.copy().TEST.NEW == {"x": 1}


def test_boxes_match(rng):
    boxes = _boxes(rng, 30)
    deltas = (rng.randn(30, 8) * 0.3).astype(np.float32)
    np.testing.assert_allclose(n(tb.bbox_pred(t(boxes), t(deltas))),
                               np.asarray(jb.bbox_pred(jnp.asarray(boxes),
                                                       jnp.asarray(deltas))), **TOL)
    big = _boxes(rng, 30, -50, 300)
    np.testing.assert_allclose(
        n(tb.clip_boxes(t(big.reshape(15, 8)), (120.0, 150.0))),
        np.asarray(jb.clip_boxes(jnp.asarray(big.reshape(15, 8)), (120.0, 150.0))),
        **TOL)
    q = _boxes(rng, 17)
    np.testing.assert_allclose(n(tb.bbox_overlaps(t(boxes), t(q))),
                               np.asarray(jb.bbox_overlaps(jnp.asarray(boxes),
                                                           jnp.asarray(q))), **TOL)
    im_hw = (np.float32(150.0), np.float32(180.0))
    means, stds = (0.0, 0.0, 0.0, 0.0), (0.1, 0.1, 0.2, 0.2)
    got = n(tb.refine_bbox(t(boxes), t(deltas), im_hw=(t(im_hw[0]), t(im_hw[1])),
                           means=means, stds=stds))
    want = np.asarray(jb.refine_bbox(jnp.asarray(boxes), jnp.asarray(deltas),
                                     im_hw=im_hw, means=means, stds=stds))
    assert got.shape == (30, 4, 2)
    np.testing.assert_allclose(got, want, **TOL)


def test_anchors_match():
    for stride, ratios, scales in [(16, (0.5, 1, 2), (4, 8, 16, 32)),
                                   (16, (0.5, 1, 2), (2, 4))]:
        np.testing.assert_array_equal(ta.generate_anchors(stride, ratios, scales),
                                      ja.generate_anchors(stride, ratios, scales))


def test_embeddings_match(rng):
    boxes = _boxes(rng, 12)
    # a degenerate box exercises the 1e-3 clamps
    boxes[3] = [50.0, 50.0, 48.0, 48.5]
    np.testing.assert_allclose(
        n(te.extract_position_matrix_t(t(boxes), 9)),
        np.asarray(je.extract_position_matrix_t(jnp.asarray(boxes), 9)), **TOL)
    mb = np.stack([_boxes(rng, 7) for _ in range(3)], 1)        # [N, C, 4]
    np.testing.assert_allclose(
        n(te.extract_multi_position_matrix_t(t(mb))),
        np.asarray(je.extract_multi_position_matrix_t(jnp.asarray(mb))), **TOL)
    np.testing.assert_allclose(n(te.extract_rank_embedding(16, 1024)),
                               np.asarray(je.extract_rank_embedding(16, 1024)),
                               **TOL)


@pytest.mark.parametrize("max_keep", [None, 10])
def test_greedy_nms_mask_matches(rng, max_keep):
    centers = rng.uniform(40, 200, (8, 2))
    cxy = centers[rng.randint(0, 8, 200)] + rng.uniform(-10, 10, (200, 2))
    wh = rng.uniform(15, 60, (200, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], 1).astype(np.float32)
    scores = rng.uniform(0, 1, 200).astype(np.float32)
    valid = rng.uniform(0, 1, 200) > 0.1
    got = n(tn.greedy_nms_mask(t(boxes), t(scores), 0.5, t(valid),
                               block_size=64, max_keep=max_keep))
    want = np.asarray(jn.greedy_nms_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                         0.5, jnp.asarray(valid), block_size=64,
                                         max_keep=max_keep))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_boxes,top_k", [(300, 40), (100, 80)])
def test_nms_topk_presorted_matches(rng, n_boxes, top_k):
    """Proposal-path NMS on presorted planar boxes; top_k larger than the
    kept count exercises the cycling pad. Indices and real mask equal."""
    centers = rng.uniform(40, 400, (10, 2))
    cxy = centers[rng.randint(0, 10, n_boxes)] + rng.uniform(-15, 15, (n_boxes, 2))
    wh = rng.uniform(20, 80, (n_boxes, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], 1).astype(np.float32)
    scores = np.sort(rng.uniform(0, 1, n_boxes).astype(np.float32))[::-1].copy()
    valid = rng.uniform(0, 1, n_boxes) > 0.05
    bT = np.ascontiguousarray(boxes.T)
    gi, gr = tn.nms_topk_presorted(t(bT), t(scores), t(valid), 0.7, top_k)
    wi, wr = jn.nms_topk_presorted(jnp.asarray(bT), jnp.asarray(scores),
                                   jnp.asarray(valid), 0.7, top_k)
    np.testing.assert_array_equal(n(gi), np.asarray(wi))
    np.testing.assert_array_equal(n(gr), np.asarray(wr))


def test_roi_align_mxu_matches(rng):
    for H, W in [(6, 9), (9, 6)]:
        feat = rng.randn(H, W, 16).astype(np.float32)
        rois = _boxes(rng, 11, 0, 100)
        got = n(tr.roi_align_mxu(t(feat), t(rois), 1.0 / 16, 7))
        want = np.asarray(j_roi_align_mxu(jnp.asarray(feat), jnp.asarray(rois),
                                         1.0 / 16, 7))
        np.testing.assert_allclose(got, want, **TOL)


def test_roi_align_sends_no_gradient_to_rois(rng):
    import torch
    feat = t(rng.randn(6, 8, 4).astype(np.float32)).requires_grad_()
    rois = t(_boxes(rng, 5, 0, 90)).requires_grad_()
    tr.roi_align_mxu(feat, rois, 1.0 / 16, 7).sum().backward()
    assert rois.grad is None and feat.grad is not None
    assert torch.isfinite(feat.grad).all()


def test_generate_proposals_match(rng):
    from relation_tpu.models.rpn import generate_proposals as jg
    from relation_tpu_torch.models.rpn import generate_proposals as tg
    H, W, A = 6, 8, 6
    fg = rng.uniform(0, 1, (H, W, A)).astype(np.float32)
    deltas = (rng.randn(H, W, A, 4) * 0.2).astype(np.float32)
    base = ja.generate_anchors(16, (0.5, 1, 2), (2, 4)).astype(np.float32)
    im_info = np.asarray([90.0, 120.0, 1.0], np.float32)
    got = tg(t(fg), t(deltas), t(base), t(im_info), 16, 200, 30, 0.7, 0.0)
    want = jg(jnp.asarray(fg), jnp.asarray(deltas), jnp.asarray(base),
              jnp.asarray(im_info), 16, 200, 30, 0.7, 0.0)
    np.testing.assert_allclose(n(got[0]), np.asarray(want[0]), **TOL)
    np.testing.assert_array_equal(n(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(n(got[2]), np.asarray(want[2]))
