"""The port's drivers (relation_tpu_torch/experiments/) against the JAX
package's, on the CPU with the tiny trunk, in a working directory holding a
mini COCO-layout dataset (tools/mini_coco.py: PNG files, crowd boxes, COCO
ids with gaps) at the YAML's ./data/coco:

- train.py for two steps through the TrainLoader (flipped entries, uint8
  s2d batches); its checkpoint and params file read by JAX's
  read_params_blob to the port's parameters; JAX re-saves them with its
  save_params; JAX's experiments/test.py evaluates the port's file and the
  port's test driver JAX's file, with the same detections in the band of
  tests/test_torch_evaluator.py (classes equal, scores within 1e-3, boxes
  within 1e-2 px) and the port's results equal to JAX's evaluator on the
  port's detections. JAX's loader is given the port's resize here (the two
  resizes differ by a grey level on a few pixels, tests/test_torch_data.py);
- rcnn_end2end_train_test: train, then test on the newest params file
  (--steps stops short of TRAIN.end_epoch), with --vis; rcnn_test with
  --debug;
  --test-epoch and the __meta__ roi_method "pool", which is not ported;
- rcnn_train_test --dataset-path through stage 4 (the test set's proposals,
  then pred_eval_rcnn), and its stage-1 and stage-3 batches equal to the JAX
  driver's on the same roidb and proposal pickle;
- the train driver's --synthetic mode and TRAIN.RESUME.
"""

import os
import sys

import numpy as np
import pytest

from relation_tpu_torch.tools.mini_coco import write_mini_coco
from tests.test_torch_evaluator import _check_dets, _jax_results

TINY_YAML = """\
symbol: resnet_v1_101_rcnn_attention_1024_pairwise_position_multi_head_16_learn_nms
output_path: ./output/tiny
CLASS_AGNOSTIC: true
SCALES: [64, 96]
dataset:
  dataset: coco
  dataset_path: ./data/coco
  image_set: minitrain+minival
  test_image_set: minitest
  NUM_CLASSES: 5
network:
  PIXEL_MEANS: [103.06, 115.90, 123.15]
  ANCHOR_SCALES: [2, 4]
  ANCHOR_RATIOS: [0.5, 1, 2]
  NUM_ANCHORS: 6
  NMS_TARGET_THRESH: '0.5, 0.7'
TRAIN:
  lr: 0.01
  lr_step: '5.33'
  end_epoch: 3
  model_prefix: rcnn_tiny
  BATCH_IMAGES: 1
  FLIP: true
  LEARN_NMS: true
  BATCH_ROIS: -1
  ENABLE_OHEM: true
  BATCH_ROIS_OHEM: 16
  FIRST_N: 8
  RPN_PRE_NMS_TOP_N: 64
  RPN_POST_NMS_TOP_N: 24
  RPN_MIN_SIZE: 0
  BBOX_NORMALIZATION_PRECOMPUTED: true
TEST:
  HAS_RPN: true
  LEARN_NMS: true
  FIRST_N: 8
  RPN_PRE_NMS_TOP_N: 64
  RPN_POST_NMS_TOP_N: 24
  RPN_MIN_SIZE: 0
  PROPOSAL_PRE_NMS_TOP_N: 96
  PROPOSAL_POST_NMS_TOP_N: 32
  PROPOSAL_MIN_SIZE: 0
  TOP_ROIS: 24
  max_per_image: 10
TPU:
  IMAGE_BUCKETS: [[64, 96], [96, 64]]
  MAX_GT: 8
"""
CAT_IDS = (3, 13, 27, 90)


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """tmp_path as the working directory, with the YAML and the dataset
    (two training sets of landscape and portrait images; a landscape test
    set, so that JAX compiles one bucket)."""
    monkeypatch.chdir(tmp_path)
    write_mini_coco("data/coco", {"minitrain": [(48, 64), (64, 48), (48, 64)],
                                  "minival": [(64, 48), (48, 64)],
                                  "minitest": [(48, 64)] * 3},
                    seed=5, cat_ids=CAT_IDS)
    (tmp_path / "tiny.yaml").write_text(TINY_YAML)
    return "tiny.yaml"


def _jax_template(yaml):
    from relation_tpu.config.defaults import load_config
    from tests.test_torch_helpers import jax_tiny_family
    return jax_tiny_family(load_config(yaml))[1]


def test_train_then_test_drivers_hand_off_to_jax(workdir, monkeypatch):
    import relation_tpu.data.image as jimage
    import relation_tpu_torch.data.image as timage
    from experiments import test as jtest
    from relation_tpu.core.checkpoint import (params_from_blob,
                                              read_params_blob, save_params)
    from relation_tpu_torch.convert import to_jax_params
    from relation_tpu_torch.data.coco import CocoDataset
    from relation_tpu_torch.experiments import test as ttest
    from relation_tpu_torch.experiments import train as ttrain
    from tests.test_torch_helpers import flat_numpy

    out = ttrain.main(["--cfg", workdir, "--steps", "2", "--tiny",
                       "--device", "cpu", "--dataset-path", "ignored"])
    assert len(out["step_s"]) == 2 and np.isfinite(out["metrics"]["total_loss"])
    assert out["params"].endswith("rcnn_tiny-0001.params.msgpack")
    assert os.path.exists(out["checkpoint"])
    assert os.path.exists(os.path.join(os.path.dirname(out["params"]),
                                       "tiny.yaml"))          # the snapshot
    want = to_jax_params(out["model"].state_dict())
    template = _jax_template(workdir)
    for path in (out["params"], out["checkpoint"]):
        blob, _ = read_params_blob(path)
        got = flat_numpy(params_from_blob(blob, template))
        assert set(got) == set(want)
        assert all(np.array_equal(got[k], want[k]) for k in want), path
    jax_file = save_params("jax.params.msgpack",
                           params_from_blob(read_params_blob(out["params"])[0],
                                            template))

    monkeypatch.setattr(jimage, "resize_im", timage.resize_im)
    monkeypatch.setattr(sys, "argv", ["test.py", "--cfg", workdir, "--tiny",
                                      "--ckpt", out["params"]])
    _, jdets = jtest.main()
    res, dets = ttest.main(["--cfg", workdir, "--tiny", "--device", "cpu",
                            "--ckpt", jax_file])
    assert sum(len(d) for d in dets.values()) > 0
    _check_dets(dets, jdets)
    from relation_tpu.data.coco import CocoDataset as JDataset
    root = "data/coco"
    jds = JDataset(f"{root}/annotations/instances_minitest.json",
                   f"{root}/images/minitest")
    np.testing.assert_equal(res, _jax_results(jds, dets))
    assert len(CocoDataset(f"{root}/annotations/instances_minitest.json")
               .image_ids) == len(dets)


def test_end2end_driver_tests_the_newest_params(workdir, monkeypatch):
    from experiments.rcnn_end2end_train_test import final_params_path as jfinal
    from relation_tpu_torch.core.checkpoint import save_params
    from relation_tpu_torch.core.trainer import build_model
    from relation_tpu_torch.config.defaults import load_config
    from relation_tpu_torch.experiments import rcnn_end2end_train_test as e2e
    from relation_tpu_torch.experiments import rcnn_test, test as ttest

    assert e2e.final_params_path(workdir) == jfinal(workdir)
    with pytest.raises(FileNotFoundError, match="no trained params"):
        e2e.trained_params_path(workdir)
    res, dets = e2e.main(["--cfg", workdir, "--steps", "2", "--tiny",
                          "--device", "cpu", "--vis"])
    newest = e2e.trained_params_path(workdir)
    assert newest.endswith("rcnn_tiny-0001.params.msgpack")
    assert set(dets) == {3001, 3002, 3003} and np.isfinite(res["AR100"])
    out_dir = os.path.join("output", "tiny", "tiny", "minitest")
    assert len(os.listdir(os.path.join(out_dir, "vis"))) == 3
    assert os.path.exists(os.path.join(out_dir, "detections.pkl"))
    # --test-epoch resolves the train driver's file; a missing epoch raises
    _, again = rcnn_test.main(["--cfg", workdir, "--tiny", "--device", "cpu",
                               "--test-epoch", "1", "--ignore-cache",
                               "--debug"])
    assert all(np.array_equal(again[k], dets[k]) for k in dets)
    with pytest.raises(FileNotFoundError, match="--test-epoch 2"):
        ttest.main(["--cfg", workdir, "--tiny", "--device", "cpu",
                    "--test-epoch", "2"])
    # a converted reference checkpoint asks for exact ROIPooling: the
    # parity mode evaluates every image
    from relation_tpu_torch.convert import init_params
    model = init_params(build_model(load_config(workdir), tiny=True,
                                    device="cpu"), seed=0)
    save_params("pool.params.msgpack", model, meta={"roi_method": "pool"})
    _, pooled = ttest.main(["--cfg", workdir, "--tiny", "--device", "cpu",
                            "--ckpt", "pool.params.msgpack", "--ignore-cache"])
    assert set(pooled) == set(dets)


def test_rcnn_train_test_dataset_through_stage4(workdir):
    """One training set: the alternate workflow reads cfg.dataset.image_set
    as one set, as the JAX driver does."""
    import pickle
    from relation_tpu_torch.experiments.rcnn_train_test import main
    with open("alt.yaml", "w") as f:
        f.write(TINY_YAML.replace("minitrain+minival", "minitrain"))
    out = main(["--cfg", "alt.yaml", "--dataset-path", "data/coco", "--steps",
                "2", "--tiny", "--device", "cpu", "--train-shared"])
    for k in ("proposals", "test_proposals", "checkpoint", "params"):
        assert os.path.exists(out[k]), k
    with open(out["test_proposals"], "rb") as f:
        props = pickle.load(f)
    assert len(props) == 3 and all(p.shape[1] == 5 and len(p) for p in props)
    assert set(out["detections"]) == {3001, 3002, 3003}
    assert np.isfinite(out["results"]["AR100"])
    assert np.isfinite(out["metrics"]["total_loss"])


def _fake_stages(monkeypatch, module, record, jax_side: bool):
    """Replaces the workflow functions that ``module``'s driver calls: the
    proposal dump writes the same seeded proposals [N, 5] (sorted by score,
    5 to 11 an image, so that TRAIN.TOP_ROIS cuts some), and the two
    training steps record their batches (in JAX through a debug callback,
    the step being jitted by the driver) and change nothing."""
    import pickle

    def dump(*args, **kwargs):
        roidb, path = args[-2], args[-1]
        rng = np.random.RandomState(7)
        props = []
        for e in roidb:
            n = rng.randint(5, 12)
            xy = rng.uniform(0, [e["width"] / 2, e["height"] / 2], (n, 2))
            wh = rng.uniform(4, [e["width"] / 2, e["height"] / 2], (n, 2))
            props.append(np.concatenate([xy, xy + wh, -np.sort(
                -rng.uniform(0, 1, (n, 1)), 0)], 1).astype(np.float32))
        with open(path, "wb") as f:
            pickle.dump(props, f)

    def step_of(stage, **kwargs):
        record.setdefault(stage + "_args", kwargs)
        if jax_side:
            import jax

            def step(state, batch):
                jax.debug.callback(lambda b: record[stage].append(
                    {k: np.asarray(v) for k, v in b.items()}), batch)
                return state, {"total_loss": 0.0}
        else:
            def step(state, batch):
                record[stage].append({k: np.asarray(v) for k, v in batch.items()})
                return state, {"total_loss": 0.0}
        return step

    monkeypatch.setattr(module, "generate_rpn_proposals", dump)
    monkeypatch.setattr(module, "make_train_step_rpn",
                        lambda model, cfg, **kw: step_of("rpn", **kw))
    monkeypatch.setattr(module, "make_train_step_rcnn",
                        lambda model, cfg, **kw: step_of("rcnn", **kw))


def test_rcnn_train_test_stage_batches_match_jax(workdir, monkeypatch):
    """rcnn_train_test --dataset-path: the batches of stage 1 (the cycled
    TrainLoader) and stage 3 (an image paired with its cached proposals,
    scaled by im_info, rois_valid) and the stage-3 step's arguments (R,
    MAX_GT, the bbox-target statistics of the TRAIN.TOP_ROIS proposals)
    equal the JAX driver's on the same roidb (flipped entries) and proposal
    pickle, over seven steps of six entries. The two drivers' training
    steps and proposal dumps are replaced (the stages themselves are held
    against JAX in tests/test_torch_rpn_workflow.py); JAX's loader is given
    the port's resize, as above."""
    import relation_tpu.core.rpn_workflow as jw
    import relation_tpu.data.image as jimage
    import relation_tpu_torch.core.rpn_workflow as tw
    import relation_tpu_torch.data.image as timage
    from experiments import rcnn_train_test as jdriver
    from relation_tpu_torch.experiments.rcnn_train_test import main
    with open("alt.yaml", "w") as f:
        f.write(TINY_YAML.replace("minitrain+minival", "minitrain")
                .replace("test_image_set: minitest", "test_image_set: none")
                .replace("  BBOX_NORMALIZATION_PRECOMPUTED: true\n",
                         "  BBOX_NORMALIZATION_PRECOMPUTED: false\n"
                         "  TOP_ROIS: 6\n"))
    argv = ["--cfg", "alt.yaml", "--dataset-path", "data/coco", "--steps", "7",
            "--tiny"]
    want = {"rpn": [], "rcnn": []}
    got = {"rpn": [], "rcnn": []}
    _fake_stages(monkeypatch, jw, want, jax_side=True)
    _fake_stages(monkeypatch, tw, got, jax_side=False)
    monkeypatch.setattr(jimage, "resize_im", timage.resize_im)
    monkeypatch.setattr(sys, "argv", ["rcnn_train_test.py"] + argv)
    jdriver.main()
    main(argv + ["--device", "cpu"])
    for stage in ("rpn", "rcnn"):
        assert len(got[stage]) == len(want[stage]) == 7, stage
        for i, (g, w) in enumerate(zip(got[stage], want[stage])):
            assert g.keys() == w.keys(), (stage, i)
            for k in w:
                assert g[k].dtype == w[k].dtype, (stage, i, k)
                np.testing.assert_array_equal(g[k], w[k],
                                              err_msg=f"{stage} {i} {k}")
    assert got["rcnn"][0]["rois"].shape == (1, 11, 4)
    assert {b["rois_valid"].sum() for b in got["rcnn"]} != {6}
    g, w = got["rcnn_args"], want["rcnn_args"]
    for k in ("max_rois", "max_gt", "train_shared"):
        assert g[k] == w[k], k
    for k in ("bbox_means", "bbox_stds"):
        np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))


def test_train_driver_synthetic_and_resume(workdir):
    """--synthetic N trains on seeded random images with no dataset read;
    TRAIN.RESUME restarts from TRAIN.begin_epoch's checkpoint (the step
    count carried on) and writes the next epoch's pair."""
    from relation_tpu_torch.experiments import train as ttrain
    first = ttrain.main(["--cfg", workdir, "--synthetic", "2", "--steps", "2",
                         "--tiny", "--device", "cpu"])
    assert first["state"].step == 2 and len(first["step_s"]) == 2
    assert first["checkpoint"].endswith("rcnn_tiny-0001.ckpt")
    with open("resume.yaml", "w") as f:
        f.write(TINY_YAML.replace("  end_epoch: 3\n", "  end_epoch: 2\n"
                                  "  begin_epoch: 1\n  RESUME: true\n"))
    os.makedirs(os.path.join("output", "tiny", "resume", "minitrain+minival"))
    for ext in ("ckpt", "params.msgpack"):
        os.replace(os.path.join("output", "tiny", "tiny", "minitrain+minival",
                                f"rcnn_tiny-0001.{ext}"),
                   os.path.join("output", "tiny", "resume", "minitrain+minival",
                                f"rcnn_tiny-0001.{ext}"))
    again = ttrain.main(["--cfg", "resume.yaml", "--synthetic", "2",
                         "--steps", "1", "--tiny", "--device", "cpu"])
    assert again["state"].step == 3       # the restored state's 2, plus 1
    assert again["params"].endswith("rcnn_tiny-0002.params.msgpack")
