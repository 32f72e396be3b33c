"""Port parity of the data path: relation_tpu/data/{image,coco,loader,eval}.py
and relation_tpu/utils/native.py against relation_tpu_torch's copies, on
the same numpy inputs from a seed.

Tolerances: everything is equal, bit for bit, except the resize. The JAX
package resizes with PIL's BILINEAR, the port with torch's antialiased
bilinear interpolate: measured here, bit-equal at most sizes and at most
one grey level apart on at most 0.3% of the pixels at the others (RESIZE_*
below). The loader tests use sizes where the two are bit-equal.
"""

import json
import os

import numpy as np
import pytest

import relation_tpu.data.coco as jcoco
import relation_tpu.data.eval as jeval
import relation_tpu.data.image as jimage
import relation_tpu.data.loader as jloader
import relation_tpu.utils.native as jnative
import relation_tpu_torch.data.coco as tcoco
import relation_tpu_torch.data.eval as teval
import relation_tpu_torch.data.image as timage
import relation_tpu_torch.data.loader as tloader
import relation_tpu_torch.utils.native as tnative
from relation_tpu.config.defaults import default_config as j_default_config
from relation_tpu_torch.config.defaults import default_config
from relation_tpu_torch.tools.mini_coco import array_loader, write_mini_coco
from tests.test_eval_oracle import _dt, _gt, _random_case

RESIZE_MAX_LEVELS = 1          # grey levels
RESIZE_MAX_SHARE = 3e-3        # of the pixels
# (image size, SCALES): COCO-like sizes at the YAMLs' (600, 1000), and the
# tests' tiny images at (64, 96)
SIZES = [((240, 320), (600, 1000)), ((480, 640), (600, 1000)),
         ((800, 1200), (600, 1000)), ((427, 640), (600, 1000)),
         ((640, 480), (600, 1000)), ((333, 500), (600, 1000)),
         ((1000, 700), (600, 1000)), ((48, 64), (64, 96)),
         ((64, 48), (64, 96))]


def _band(got, want):
    d = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert d.max() <= RESIZE_MAX_LEVELS, d.max()
    assert (d > 0).mean() <= RESIZE_MAX_SHARE, (d > 0).mean()


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("hw,scales", SIZES)
def test_resize_matches_pil(hw, scales, dtype):
    rng = np.random.RandomState(hw[0])
    im = (rng.rand(*hw, 3) * 255).astype(dtype)
    want, s_want = jimage.resize_im(im, *scales)
    got, s_got = timage.resize_im(im, *scales)
    assert s_got == s_want and got.shape == want.shape and got.dtype == np.uint8
    _band(got, want)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("means", [None, (103.06, 115.90, 123.15)])
@pytest.mark.parametrize("hw", [(427, 640), (640, 480), (48, 64)])
def test_prepare_image_matches_jax(hw, means, flip):
    rng = np.random.RandomState(7)
    im = rng.randint(0, 256, (*hw, 3)).astype(np.uint8)
    boxes = np.asarray([[3, 4, 30, 40, 2], [10.5, 0, hw[1] - 1, hw[0] - 1, 5]],
                       np.float32)
    scale = (64, 96) if hw == (48, 64) else (600, 1000)
    buckets = [(64, 96), (96, 64)] if hw == (48, 64) else [
        (608, 1024), (800, 1024), (1024, 1024)]
    want = jimage.prepare_image(im, *scale, means, buckets, flip=flip,
                                boxes=boxes)
    got = timage.prepare_image(im, *scale, means, buckets, flip=flip,
                               boxes=boxes)
    assert got[0].shape == want[0].shape and got[0].dtype == want[0].dtype
    _band(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_layout_helpers_bit_equal():
    rng = np.random.RandomState(3)
    im = rng.randint(0, 256, (64, 96, 3)).astype(np.uint8)
    np.testing.assert_array_equal(timage.to_s2d_planar(im),
                                  jimage.to_s2d_planar(im))
    buckets = [(608, 1024), (800, 1024), (1024, 1024)]
    for h, w in [(600, 800), (800, 600), (608, 1024), (609, 1000), (1100, 90)]:
        assert timage.pick_bucket(h, w, buckets) == jimage.pick_bucket(
            h, w, buckets)
    small = rng.rand(50, 70, 3).astype(np.float32)
    np.testing.assert_array_equal(timage.pad_to_bucket(small, (64, 96)),
                                  jimage.pad_to_bucket(small, (64, 96)))
    for mod in (timage, jimage):
        with pytest.raises(ValueError, match="exceeds the largest image bucket"):
            mod.pad_to_bucket(small, (48, 96))
    s2d = np.zeros((2, 12, 32, 48))
    assert timage.batch_image_hw(s2d) == jimage.batch_image_hw(s2d) == (64, 96)
    assert timage.image_hw(s2d[0]) == jimage.image_hw(s2d[0]) == (64, 96)
    b = np.asarray([[0, 1, 10, 20], [5, 5, 5, 5]], np.float32)
    np.testing.assert_array_equal(timage.flip_boxes(b, 64),
                                  jimage.flip_boxes(b, 64))


@pytest.fixture
def mini(tmp_path):
    """Landscape and portrait images (both sizes resize bit-equally in the
    two packages at SCALES (64, 96)), crowd boxes, COCO ids with gaps."""
    sets = {"minitrain": [(48, 64), (64, 48), (48, 64), (48, 64), (64, 48)],
            "minitest": [(48, 64), (64, 48), (48, 64)]}
    arrays = write_mini_coco(str(tmp_path), sets, seed=4)
    return tmp_path, arrays


def _datasets(root, s):
    ann = os.path.join(root, "annotations", f"instances_{s}.json")
    img = os.path.join(root, "images", s)
    return tcoco.CocoDataset(ann, img), jcoco.CocoDataset(ann, img)


def _assert_roidb_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            if isinstance(g[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k


@pytest.mark.parametrize("flip", [False, True])
def test_coco_roidb_bit_equal(mini, flip):
    root, _ = mini
    t, j = _datasets(root, "minitrain")
    assert (t.cat_ids, t.cat_to_class, t.class_to_cat, t.num_classes,
            t.class_names) == (j.cat_ids, j.cat_to_class, j.class_to_cat,
                               j.num_classes, j.class_names)
    roidb = t.roidb(flip=flip)
    _assert_roidb_equal(roidb, j.roidb(flip=flip))
    assert any(e["iscrowd"].any() for e in roidb)
    assert max(t.cat_to_class) == 90            # the ids' gaps are mapped
    _assert_roidb_equal(tcoco.filter_roidb(roidb), jcoco.filter_roidb(roidb))
    # an image with crowd boxes only, and one with none, are dropped
    crowd_only = dict(roidb[0], iscrowd=np.ones(len(roidb[0]["boxes"]), bool))
    empty = dict(roidb[0], boxes=np.zeros((0, 4), np.float32),
                 iscrowd=np.zeros(0, bool))
    for mod in (tcoco, jcoco):
        assert len(mod.filter_roidb([crowd_only, empty] + roidb)) == len(
            jcoco.filter_roidb(roidb))


def test_detections_to_json_equal(mini):
    root, _ = mini
    t, j = _datasets(root, "minitest")
    rng = np.random.RandomState(2)
    dets = {i: np.concatenate([rng.randint(-1, 7, (9, 1)),
                               rng.rand(9, 1), rng.rand(9, 4) * 60], 1)
            .astype(np.float32) for i in t.image_ids}
    assert t.detections_to_json(dets) == j.detections_to_json(dets)


def _loader_cfgs(grouping, u8, s2d):
    cfgs = []
    for make in (default_config, j_default_config):
        cfg = make()
        cfg.SCALES[0] = (64, 96)
        cfg.TPU.IMAGE_BUCKETS = [(64, 96), (96, 64)]
        cfg.TPU.MAX_GT = 4
        cfg.TRAIN.ASPECT_GROUPING = grouping
        cfg.TPU.H2D_UINT8 = u8
        cfg.TPU.S2D_INPUT = s2d
        cfg.network.PIXEL_MEANS = np.array([103.06, 115.90, 123.15])
        cfgs.append(cfg)
    return cfgs


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, dict):
            assert g.keys() == w.keys()
            g, w = [g[k] for k in sorted(g)], [w[k] for k in sorted(w)]
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
            assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("grouping,u8,s2d", [(True, True, True),
                                             (False, True, True),
                                             (True, False, False),
                                             (False, False, True)])
def test_train_loader_same_batches(mini, grouping, u8, s2d):
    root, _ = mini
    t, _ = _datasets(root, "minitrain")
    roidb = tcoco.filter_roidb(t.roidb(flip=True))
    tcfg, jcfg = _loader_cfgs(grouping, u8, s2d)
    for B, workers in ((1, 4), (2, 0)):
        got = list(tloader.TrainLoader(roidb, tcfg, B, seed=3,
                                       num_workers=workers))
        want = list(jloader.TrainLoader(roidb, jcfg, B, seed=3,
                                        num_workers=workers))
        assert len(got) == len(roidb) // B
        _assert_batches_equal(got, want)


@pytest.mark.parametrize("u8,s2d", [(True, True), (False, False)])
def test_test_loaders_same_items(mini, tmp_path, u8, s2d):
    import pickle
    root, arrays = mini
    t, _ = _datasets(root, "minitest")
    roidb = t.roidb()
    tcfg, jcfg = _loader_cfgs(True, u8, s2d)
    _assert_batches_equal(list(tloader.TestLoader(roidb, tcfg)),
                          list(jloader.TestLoader(roidb, jcfg)))
    # the injected arrays give what the files give
    _assert_batches_equal(
        list(tloader.TestLoader(roidb, tcfg,
                                image_loader=array_loader(arrays))),
        list(jloader.TestLoader(roidb, jcfg)))
    rng = np.random.RandomState(0)
    props = [np.concatenate([rng.rand(n, 2) * 30, rng.rand(n, 2) * 30 + 30,
                             rng.rand(n, 1)], 1).astype(np.float32)
             for n in (5, 12, 0)]
    pkl = str(tmp_path / "props.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(props, f)
    for top in (-1, 7):
        tcfg.TEST.TOP_ROIS = jcfg.TEST.TOP_ROIS = top
        got = list(tloader.ProposalTestLoader(roidb, tcfg, pkl))
        assert got[0][3].shape == (12 if top < 0 else 8, 4)
        _assert_batches_equal(got, list(jloader.ProposalTestLoader(
            roidb, jcfg, pkl)))


@pytest.fixture(params=["native", "numpy"])
def route(request, monkeypatch):
    """The port's native library, or its NumPy versions."""
    if request.param == "numpy":
        monkeypatch.setattr(tnative, "_lib", False)
    assert tnative.have_native() == (request.param == "native")
    return request.param


def _nms_dets(seed, n=60):
    rng = np.random.RandomState(seed)
    xy = rng.rand(n, 2) * 80
    wh = rng.rand(n, 2) * 40 + 2
    return np.concatenate([xy, xy + wh, rng.rand(n, 1)], 1).astype(np.float32)


def test_native_functions_equal(route, monkeypatch):
    if route == "numpy":
        monkeypatch.setattr(jnative, "_lib", False)
    assert jnative.have_native() == tnative.have_native()
    for seed in range(3):
        d = _nms_dets(seed)
        for th in (0.3, 0.7):
            np.testing.assert_array_equal(tnative.greedy_nms(d, th),
                                          jnative.greedy_nms(d, th))
        for sigma, cap in ((0.5, -1), (0.3, 20)):
            for a, b in zip(tnative.soft_nms(d, sigma, cap),
                            jnative.soft_nms(d, sigma, cap)):
                np.testing.assert_array_equal(a, b)
        b = d[:, :4]
        np.testing.assert_array_equal(tnative.bbox_overlaps(b, b[:7]),
                                      jnative.bbox_overlaps(b, b[:7]))
    rng = np.random.RandomState(1)
    for h, w in ((7, 5), (16, 16)):
        m = (rng.rand(h, w) > 0.5).astype(np.uint8)
        m2 = (rng.rand(h, w) > 0.4).astype(np.uint8)
        ca = tnative.rle_encode(m)
        np.testing.assert_array_equal(ca, jnative.rle_encode(m))
        np.testing.assert_array_equal(tnative.rle_decode(ca, h, w),
                                      jnative.rle_decode(ca, h, w))
        np.testing.assert_array_equal(tnative.rle_decode(ca, h, w), m)
        cb = tnative.rle_encode(m2)
        for crowd in (False, True):
            assert tnative.rle_iou(ca, cb, crowd) == jnative.rle_iou(ca, cb,
                                                                     crowd)
    ious = rng.rand(6, 4)
    args = (ious, rng.rand(4) * 2e4, np.asarray([0, 1, 0, 0], np.uint8),
            rng.rand(6) * 2e4, jeval.IOU_THRS.astype(float),
            np.asarray(list(jeval.AREA_RNG.values()), float))
    got, want = tnative.coco_match_image(*args), jnative.coco_match_image(*args)
    if route == "numpy":
        assert got is None and want is None
    else:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def _both_evaluators(tmp_path, image_ids, cat_ids, gt_anns, dt_anns):
    doc = {"images": [{"id": i, "height": 480, "width": 640,
                       "file_name": f"im{i}.jpg"} for i in sorted(image_ids)],
           "categories": [{"id": c, "name": f"cat{c}"} for c in sorted(cat_ids)],
           "annotations": gt_anns}
    f = str(tmp_path / "instances.json")
    with open(f, "w") as fh:
        json.dump(doc, fh)
    out = []
    for coco, ev in ((tcoco, teval), (jcoco, jeval)):
        ds = coco.CocoDataset(f)
        e = ev.CocoEvaluator(ds)
        by_img = {}
        for a in sorted(dt_anns, key=lambda a: (a["image_id"], a["id"])):
            x, y, w, h = a["bbox"]
            by_img.setdefault(a["image_id"], []).append(
                [ds.cat_to_class[a["category_id"]], a["score"],
                 x, y, x + w - 1, y + h - 1])
        for img_id, rows in by_img.items():
            e.add_detections(img_id, np.asarray(rows, float))
        out.append((e.summarize(), ds.class_names))
    return out


def _hand_cases():
    """tests/test_eval_oracle.py's hand-built cases."""
    crowd = ([1], [1],
             [_gt(1, 1, 1, 10, 10, 40, 40),
              _gt(2, 1, 1, 100, 100, 60, 60, crowd=1),
              _gt(3, 1, 1, 200, 200, 40, 40),
              _gt(4, 1, 1, 204, 204, 41, 41, crowd=1)],
             [_dt(1, 1, 1, 10, 10, 40, 40, 0.9),
              _dt(2, 1, 1, 105, 105, 55, 55, 0.8),
              _dt(3, 1, 1, 205, 205, 40, 40, 0.7)])
    area = ([1], [1],
            [_gt(1, 1, 1, 10, 10, 32, 32), _gt(2, 1, 1, 100, 100, 96, 96),
             _gt(3, 1, 1, 300, 300, 10, 10)],
            [_dt(1, 1, 1, 10, 10, 32, 32, 0.9),
             _dt(2, 1, 1, 100, 100, 96, 96, 0.8),
             _dt(3, 1, 1, 300, 300, 10, 10, 0.7)])
    empty = ([1, 2], [1, 2], [_gt(1, 1, 1, 10, 10, 40, 40)],
             [_dt(1, 2, 1, 10, 10, 40, 40, 0.9),
              _dt(2, 1, 2, 10, 10, 40, 40, 0.8)])
    return {"crowd_fallback": crowd, "area_boundary": area,
            "dets_without_gt": empty}


def _large_case():
    """tests/test_eval_oracle.py::test_large_fixture_parity's fixture."""
    r = np.random.RandomState(7)
    image_ids, cat_ids = list(range(1, 61)), list(range(1, 11))
    gt, dt = [], []
    gid = did = 1
    for img in image_ids:
        for _ in range(r.randint(2, 9)):
            cat = int(r.choice(cat_ids))
            x, y = r.randint(0, 400, 2) * 1.0
            w = float(r.choice([8, 16, 31, 32, 33, 64, 95, 96, 97, 128]))
            h = float(r.choice([8, 16, 31, 32, 33, 64, 95, 96, 97, 128]))
            gt.append(_gt(gid, img, cat, x, y, w, h, crowd=int(r.rand() < 0.15)))
            gid += 1
            for _ in range(r.randint(0, 5)):
                dx, dy = r.randint(-10, 11, 2) * 1.0
                dt.append(_dt(did, img, cat, x + dx, y + dy,
                              max(4.0, w + r.randint(-8, 9)),
                              max(4.0, h + r.randint(-8, 9)), float(r.rand())))
                did += 1
        for _ in range(r.randint(5, 15)):
            x, y = r.randint(0, 600, 2) * 1.0
            dt.append(_dt(did, img, int(r.choice(cat_ids)), x, y,
                          float(r.randint(5, 150)), float(r.randint(5, 150)),
                          float(r.rand() * 0.5)))
            did += 1
    return image_ids, cat_ids, gt, dt


EVAL_CASES = ["crowd_fallback", "area_boundary", "dets_without_gt",
              "random_0", "random_1", "random_2", "large"]


@pytest.mark.parametrize("case", EVAL_CASES)
def test_summarize_equals_jax(tmp_path, route, case):
    """JAX's evaluator (its native route) as the oracle, the port's on each
    route: the results dicts equal (NaN where JAX has NaN), the summary
    text equal."""
    if case.startswith("random_"):
        data = _random_case(int(case[-1]))
    elif case == "large":
        data = _large_case()
    else:
        data = _hand_cases()[case]
    (got, names), (want, _) = _both_evaluators(tmp_path, *data)
    np.testing.assert_equal(got, want)
    assert teval.format_coco_summary(got, names) == jeval.format_coco_summary(
        want, names)
    assert teval.format_coco_summary(got) == jeval.format_coco_summary(want)


def test_match_image_and_iou_matrix_equal():
    rng = np.random.RandomState(5)
    d = np.concatenate([rng.rand(9, 2) * 50, rng.rand(9, 2) * 30 + 1], 1)
    g = np.concatenate([rng.rand(4, 2) * 50, rng.rand(4, 2) * 30 + 1], 1)
    crowd = np.asarray([0, 1, 0, 0], bool)
    np.testing.assert_array_equal(teval._iou_matrix(d, g, crowd),
                                  jeval._iou_matrix(d, g, crowd))
    args = (d, rng.rand(9), g, crowd | (rng.rand(4) > 0.7), crowd,
            d[:, 2] * d[:, 3], (0.0, 1e10), 5)
    for a, b in zip(teval._match_image(*args), jeval._match_image(*args)):
        np.testing.assert_array_equal(a, b)
