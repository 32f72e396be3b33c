"""Port parity of relation_tpu/core/evaluator.py: pred_eval, pred_eval_rcnn,
prewarm_buckets and the predictor's DEBUG_MONITOR taps (and
utils/debug.py, which makes them), on a mini PNG
dataset (landscape and portrait images, two buckets, crowd boxes, COCO ids
with gaps) with the tiny C4 learned-NMS model of tests/test_golden_e2e.py,
its synth_params carried into the port by from_jax_params.

The JAX functions are handed the items of the port's loaders, so that both
see the same pixels: the two resizes differ by a grey level on a few pixels
of some images (tests/test_torch_data.py holds the resize to its band),
and a random-weight model moves its detections by pixels at such a change.

Tolerances: detections with classes equal, boxes within 1e-2 px (the band
of tests/test_torch_flagship.py) and scores within 1e-3. The flagship test
holds scores to 1e-4 on its fixed input (values of std 40); on the
dataset's uint8 images (pixels up to 255 before the mean subtraction) the
random RPN's box deltas reach 6, the two frameworks' f32 trunks (which
agree to 1e-6 of their largest value) give proposals up to 2e-4 px apart,
and the learned-NMS scores move by up to 3e-4 (measured). The JAX path
runs unmodified (Pallas kernels in interpret mode). The results dict equals
JAX's evaluator's on the port's detections exactly; the cache, the results
JSON and the loader-window paths are bit-equal; the taps' triples within
1e-4 of their value (rois, cls_score, bbox_deltas) and 1e-2 (dets, whose
boxes hold the 1e-2 band).
"""

import json
import os
import pickle

import numpy as np
import pytest
import jax.numpy as jnp

import relation_tpu.core.evaluator as jev
import relation_tpu.core.rpn_workflow as jw
import relation_tpu.data.coco as jcoco
import relation_tpu.data.eval as jeval
import relation_tpu_torch.core.evaluator as tev
import relation_tpu_torch.core.rpn_workflow as tw
import relation_tpu_torch.data.coco as tcoco
from relation_tpu_torch.tools.mini_coco import array_loader, write_mini_coco
from tests.test_golden_e2e import family_cfg
from tests.test_torch_helpers import jax_tiny_family, n, port_model

TEST_SET = "minitest"
CAT_IDS = (3, 13, 27, 90)            # NUM_CLASSES 5 of the tiny config


def _cfg():
    cfg = family_cfg("plain_learn_nms")
    cfg.SCALES[0] = (64, 96)
    cfg.TPU.IMAGE_BUCKETS = [(64, 96), (96, 64)]
    cfg.TPU.MAX_GT = 8
    cfg.dataset.test_image_set = TEST_SET
    return cfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("mini_coco")
    arrays = write_mini_coco(str(root), {TEST_SET: [(48, 64), (64, 48),
                                                    (48, 64)]},
                             seed=11, cat_ids=CAT_IDS)
    ann = str(root / "annotations" / f"instances_{TEST_SET}.json")
    img = str(root / "images" / TEST_SET)
    cfg = _cfg()
    jm, params = jax_tiny_family(cfg)
    return {"cfg": cfg, "jm": jm, "params": params, "pm": port_model(cfg, params),
            "tds": tcoco.CocoDataset(ann, img), "jds": jcoco.CocoDataset(ann, img),
            "arrays": arrays}


@pytest.fixture(scope="module")
def jax_run(setup):
    """JAX's pred_eval with the monitor taps on, over the port's
    TestLoader items; its compiled predict functions are kept (one
    compile a bucket serves both tests below)."""
    from relation_tpu_torch.data.loader import TestLoader
    s = setup
    cfg = s["cfg"].copy()
    cfg.TPU.DEBUG_MONITOR = True
    items = list(TestLoader(s["tds"].roidb(), cfg))
    fns = {}
    _, dets = jev.pred_eval(s["jm"], s["params"], cfg, s["jds"], None,
                            loader=items, predict_fns=fns)
    return {"cfg": cfg, "items": items, "dets": dets, "fns": fns}


def _check_dets(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        assert g.shape == w.shape, k
        np.testing.assert_array_equal(g[:, 0], w[:, 0], err_msg=str(k))
        np.testing.assert_allclose(g[:, 1], w[:, 1], rtol=0, atol=1e-3)
        np.testing.assert_allclose(g[:, 2:], w[:, 2:], rtol=0, atol=1e-2)


def _jax_results(jds, dets):
    ev = jeval.CocoEvaluator(jds)
    for k, d in dets.items():
        ev.add_detections(k, d)
    return ev.summarize()


def test_pred_eval_matches_jax(setup, jax_run, tmp_path):
    """pred_eval of the port over the dataset's loader (uint8 s2d, two
    buckets), JAX's over the same items: detections in the band, the port's
    results dict equal to JAX's evaluator on the port's detections, the
    cache and the results JSON written, and read back by a second call, bit
    for bit."""
    s = setup
    cfg, roidb, want = jax_run["cfg"], s["tds"].roidb(), jax_run["dets"]
    cache = str(tmp_path / "out" / "detections.pkl")
    stats = {}
    res, got = tev.pred_eval(s["pm"], cfg, s["tds"], roidb, cache_path=cache,
                             stats=stats)
    assert sum(len(d) for d in got.values()) > 0
    _check_dets(got, want)
    np.testing.assert_equal(res, _jax_results(s["jds"], got))
    assert stats["images"] == 3 and stats["native"] in (True, False)
    assert all(stats[k] >= 0 for k in ("data_s", "net_s", "fetch_s", "post_s",
                                       "summarize_s"))
    with open(cache, "rb") as f:
        cached = pickle.load(f)
    res_file = tmp_path / "out" / "results" / f"detections_{TEST_SET}_results.json"
    with open(res_file) as f:
        records = json.load(f)
    assert records == json.loads(json.dumps(
        s["jds"].detections_to_json(got), sort_keys=True))
    res2, again = tev.pred_eval(s["pm"], cfg, s["tds"], roidb, cache_path=cache)
    for d in (cached, again):
        assert d.keys() == got.keys()
        assert all(np.array_equal(d[k], got[k]) for k in got)
    np.testing.assert_equal(res2, res)


def test_pred_eval_window_and_loader_paths_bit_equal(setup):
    """The window depth and the injected image arrays change nothing;
    prewarm_buckets calls the predict function once a bucket, in the
    loader's layout; a mesh of two devices raises."""
    from relation_tpu_torch.core.predictor import build_predict_fn
    from relation_tpu_torch.data.image import image_hw
    s = setup
    cfg = s["cfg"].copy()
    roidb = s["tds"].roidb()
    _, base = tev.pred_eval(s["pm"], cfg, s["tds"], roidb)
    cfg.TPU.EVAL_PIPELINE_DEPTH = 1
    predict, seen = build_predict_fn(s["pm"], cfg), []

    def recording(img, *args):
        seen.append((img.dtype, image_hw(img)))
        return predict(img, *args)

    assert tev.prewarm_buckets(recording, cfg) >= 0
    assert seen == [(np.uint8, (64, 96)), (np.uint8, (96, 64))]
    from relation_tpu_torch.data.loader import TestLoader
    loader = TestLoader(roidb, cfg, image_loader=array_loader(s["arrays"]))
    _, other = tev.pred_eval(s["pm"], cfg, s["tds"], roidb, loader=loader)
    assert all(np.array_equal(other[k], base[k]) for k in base)
    with pytest.raises(NotImplementedError, match="mesh"):
        tev.pred_eval(s["pm"], cfg, s["tds"], roidb, mesh=[0, 1])


def test_pred_eval_rcnn_from_a_loader_none_dump(setup, tmp_path):
    """generate_rpn_proposals(loader=None) over the dataset's roidb, against
    JAX's over the same images (proposals from each package's own trunk
    within 1e-3 px), then pred_eval_rcnn of the port on its file through
    its ProposalTestLoader, JAX's over the same items: detections in the
    band, results equal to JAX's evaluator on the port's detections."""
    from relation_tpu_torch.data.loader import ProposalTestLoader, TestLoader
    s = setup
    cfg = s["cfg"].copy()
    cfg.TEST.HAS_RPN = False
    cfg.TEST.PROPOSAL_PRE_NMS_TOP_N = 96
    cfg.TEST.PROPOSAL_POST_NMS_TOP_N = 32
    cfg.TEST.TOP_ROIS = 24
    # the landscape images only: one JAX compile of predict_rcnn
    troidb = [e for e in s["tds"].roidb() if e["width"] > e["height"]]
    jpkl, tpkl = str(tmp_path / "j.pkl"), str(tmp_path / "t.pkl")
    jw.generate_rpn_proposals(s["jm"], s["params"], cfg, None, jpkl,
                              loader=list(TestLoader(troidb, cfg)))
    tw.generate_rpn_proposals(s["pm"], cfg, troidb, tpkl, device="cpu")
    with open(jpkl, "rb") as f:
        jp = pickle.load(f)
    with open(tpkl, "rb") as f:
        tp = pickle.load(f)
    assert len(tp) == len(jp) == len(troidb) == 2
    for g, w in zip(tp, jp):
        assert g.shape == w.shape and len(w) >= 4
        np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=1e-3)
    _, want = jev.pred_eval(s["jm"], s["params"], cfg, s["jds"], None,
                            loader=list(ProposalTestLoader(troidb, cfg, tpkl)),
                            proposal_file=tpkl)
    res, got = tev.pred_eval_rcnn(s["pm"], cfg, s["tds"], troidb, tpkl)
    assert sum(len(d) for d in got.values()) > 0
    _check_dets(got, want)
    np.testing.assert_equal(res, _jax_results(s["jds"], got))


def test_debug_monitor_taps_match_jax(setup, jax_run, capsys):
    """TPU.DEBUG_MONITOR: the tap names of JAX's make_predict_fn and their
    [min, max, mean] triples on every image; pred_eval logs them."""
    from relation_tpu.data.image import image_hw
    from relation_tpu_torch.core.predictor import make_predict_fn
    s = setup
    cfg = jax_run["cfg"]
    predict = make_predict_fn(s["pm"], cfg)
    for _, img, info in jax_run["items"]:
        got = predict(img, info)["monitor"]
        h, w = image_hw(img)
        want = jax_run["fns"][(h // 16, w // 16)](
            s["params"], jnp.asarray(img), jnp.asarray(info), None)["monitor"]
        assert list(got) == ["rois", "cls_score", "bbox_deltas", "dets"]
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(n(got[k]), np.asarray(want[k]),
                                       rtol=1e-4,
                                       atol=1e-2 if k == "dets" else 1e-4,
                                       err_msg=k)
    assert "monitor" not in make_predict_fn(s["pm"], s["cfg"])(img, info)
    tev.pred_eval(s["pm"], cfg, s["tds"], s["tds"].roidb()[:1])
    assert "[monitor] image" in capsys.readouterr().out


def test_debug_utils_match_jax(capsys):
    """utils/debug.py: tensor_stats equals JAX's triple on the same array;
    monitor is the identity, gradient included, and prints its summary."""
    import torch
    from relation_tpu.utils.debug import tensor_stats as j_stats
    from relation_tpu_torch.utils.debug import monitor, tensor_stats
    x = np.random.RandomState(3).randn(7, 5).astype(np.float32)
    np.testing.assert_allclose(n(tensor_stats(torch.from_numpy(x))),
                               np.asarray(j_stats(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)
    t = torch.from_numpy(x).requires_grad_()
    y = monitor(t, "probe")
    y.sum().backward()
    assert y is t and torch.equal(t.grad, torch.ones_like(t))
    assert "[monitor] probe shape=(7, 5) min=" in capsys.readouterr().out
    monitor(t, "bare", stats=False)
    assert capsys.readouterr().out.strip() == "[monitor] bare shape=(7, 5)"
