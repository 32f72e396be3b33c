"""Data parallelism of the port (relation_tpu_torch/parallel/) on the CPU:
two gloo ranks spawned from the test process (parallel/launch.py::spawn, a
file:// store in a temporary directory, one CPU thread a rank).

- the data-parallel train step against one process's step on the same
  global batch of four images, at the JAX package's tolerance for the same
  check (tests/test_train_predict.py::test_train_step_sharded_dp_parity:
  rtol 1e-4, atol 1e-6, reduction order only), with OHEM off as there;
- the train driver under two ranks against one process at twice
  TRAIN.BATCH_IMAGES;
- pred_eval over two ranks bit-equal to the sequential pred_eval on a
  dataset of two buckets with a partial last group;
- each rank decoding only its images: the train loader's shares, the
  inference groups from the roidb's sizes;
- entry.py::dryrun_multichip(2);
- make_mesh and shard_batch.
"""

import os

import numpy as np
import pytest
import torch

from relation_tpu_torch.parallel import launch
from relation_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch
from tests.test_golden_e2e import family_cfg
from tests.test_golden_train import _fixed_batch


def test_dp_step_matches_the_one_process_step():
    """Every leaf and metric of the two-rank step within rtol 1e-4, atol
    1e-6 of one process's step on the four images, with the anchors'
    random subsampling binding; the ranks bit-equal; the update moved
    leaves."""
    cfg = family_cfg("plain_learn_nms")
    cfg.TRAIN.ENABLE_OHEM = False
    # fewer anchors sampled than are eligible (a 128x128 image, 16 a batch):
    # the ranks' random priorities decide which (a rank that drew another
    # image's priorities would train on other anchors)
    cfg.TRAIN.RPN_BATCH_SIZE = 16
    batch = _fixed_batch(B=4, size=128)
    ranks = launch.spawn(launch.train_steps, 2, cfg, batch, True, threads=1)
    ref = launch.train_steps(make_mesh(device="cpu"), cfg, batch, tiny=True)
    assert ranks[0]["digest"] == ranks[1]["digest"]
    assert "params" not in ranks[1]
    got, want = ranks[0]["metrics"][0], ref["metrics"][0]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    for k, v in ref["params"].items():
        np.testing.assert_allclose(ranks[0]["params"][k], v, rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(ranks[0]["init"]["rpn.rpn_conv_3x3.weight"],
                                  ref["init"]["rpn.rpn_conv_3x3.weight"])
    assert launch.update_agreement(ref["init"], ref["params"],
                                   ranks[0]["params"])["moved"] > 20


def test_train_driver_under_two_ranks(tmp_path, monkeypatch):
    """experiments/train.py --synthetic on two ranks (a global batch of
    2 x TRAIN.BATCH_IMAGES) against one process with TRAIN.BATCH_IMAGES
    doubled: the params file rank 0 writes within rtol 1e-4, atol 1e-6 of
    the one-process file."""
    from relation_tpu_torch.core.checkpoint import load_params
    from relation_tpu_torch.core.trainer import build_model
    from relation_tpu_torch.config.defaults import load_config
    from tests.test_torch_drivers import TINY_YAML
    monkeypatch.chdir(tmp_path)
    yaml = TINY_YAML.replace("ENABLE_OHEM: true", "ENABLE_OHEM: false")
    (tmp_path / "dp.yaml").write_text(yaml)
    (tmp_path / "one.yaml").write_text(
        yaml.replace("BATCH_IMAGES: 1", "BATCH_IMAGES: 2"))
    argv = ["--synthetic", "2", "--steps", "1", "--tiny", "--device", "cpu"]
    ranks = launch.spawn(launch.run_driver, 2, "relation_tpu_torch.experiments.train",
                         ["--cfg", "dp.yaml", *argv], threads=1)
    one = launch.run_driver(make_mesh(device="cpu"),
                            "relation_tpu_torch.experiments.train",
                            ["--cfg", "one.yaml", *argv])
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    model = build_model(load_config("dp.yaml"), tiny=True, device="cpu")
    got = load_params(ranks[0]["files"]["params"], model)
    want = load_params(one["files"]["params"], model)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(ranks[0]["metrics"][k], v, rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_dp_pred_eval_is_bit_equal_to_the_sequential_run(tmp_path, monkeypatch):
    """Five test images in two buckets (three landscape: a group of two and
    a partial group padded with its last image; two portrait): the
    detections of every image on both ranks, in the loader's order, equal to
    the sequential pred_eval's bit for bit."""
    from relation_tpu_torch.config.defaults import load_config
    from relation_tpu_torch.tools.mini_coco import write_mini_coco
    from tests.test_torch_drivers import TINY_YAML
    monkeypatch.chdir(tmp_path)
    write_mini_coco("data/coco", {"minitest": [(48, 64), (64, 48), (48, 64),
                                               (64, 48), (48, 64)]}, seed=3)
    (tmp_path / "tiny.yaml").write_text(TINY_YAML)
    cfg = load_config("tiny.yaml")
    cfg.TEST.SCORE_THRESH = 0.0
    ranks = launch.spawn(launch.pred_eval_rank, 2, cfg, "data/coco", "minitest",
                         True, threads=1)
    seq = launch.pred_eval_rank(make_mesh(device="cpu"), cfg, "data/coco",
                                "minitest", tiny=True)
    want = seq["dets"]
    assert len(want) == 5 and sum(len(d) for d in want.values()) > 0
    for r in ranks:
        assert list(r["dets"]) == list(want)
        for k, v in want.items():
            np.testing.assert_array_equal(r["dets"][k], v, err_msg=str(k))
        assert r["stats"]["images"] == 5


def test_rank_shares_decode_only_their_images(tmp_path, monkeypatch):
    """Each data-parallel rank decodes only its images. TrainLoader with
    shard=(r, 2): rank r's batches are rows r of one process's batches of
    the global size, padded alike (mixed buckets in a batch: a rank's share
    padded to the whole batch's largest bucket), each image decoded by one
    rank. pred_eval's groups from the roidb's sizes (shard_groups) are the
    groups the decoded images' shapes give, and a rank's subset loader
    decodes one image a group."""
    from relation_tpu_torch.config.defaults import load_config
    from relation_tpu_torch.core.evaluator import shard_groups
    from relation_tpu_torch.data.coco import coco_dataset, filter_roidb
    from relation_tpu_torch.data.image import image_hw, pick_bucket
    from relation_tpu_torch.data.loader import TestLoader, TrainLoader
    from relation_tpu_torch.tools.mini_coco import array_loader, write_mini_coco
    from tests.test_torch_drivers import TINY_YAML
    monkeypatch.chdir(tmp_path)
    sizes = [(48, 64), (64, 48), (48, 64), (64, 48), (64, 48), (48, 64),
             (48, 64)]
    arrays = write_mini_coco("data/coco", {"minitrain": sizes,
                                           "minitest": sizes}, seed=5, png=False)
    (tmp_path / "tiny.yaml").write_text(TINY_YAML)
    cfg = load_config("tiny.yaml")
    cfg.TRAIN.ASPECT_GROUPING = False
    serve = array_loader(arrays)
    decoded = []

    def counting(path):
        decoded.append(path)
        return serve(path)
    roidb = filter_roidb(coco_dataset("data/coco", "minitrain").roidb(flip=True))
    # seed 1: three of the six shares hold one bucket of a two-bucket batch
    one = list(TrainLoader(roidb, cfg, 4, seed=1, image_loader=counting))
    assert len(decoded) == 4 * len(one) == 12
    padded = 0
    for r in range(2):
        decoded.clear()
        share = list(TrainLoader(roidb, cfg, 4, seed=1, shard=(r, 2),
                                 image_loader=counting))
        assert len(decoded) == 2 * len(one)
        assert len(share) == len(one)
        for g, w in zip(share, one):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k][2 * r:2 * r + 2])
            own = [pick_bucket(int(h), int(w), cfg.TPU.IMAGE_BUCKETS)
                   for h, w, _ in g["im_info"]]
            own_hw = (max(h for h, _ in own), max(w for _, w in own))
            padded += own_hw != tuple(s * 2 for s in g["image"].shape[2:])
    assert padded > 0, "no batch mixed buckets"
    test_roidb = coco_dataset("data/coco", "minitest").roidb()
    loader = TestLoader(test_roidb, cfg, image_loader=counting)
    groups = shard_groups(test_roidb, cfg, 2)
    by_shape, want = {}, []
    for i, (_, img, _) in enumerate(loader):
        by_shape.setdefault(image_hw(img), []).append(i)
        if len(by_shape[image_hw(img)]) == 2:
            want.append(by_shape.pop(image_hw(img)))
    assert groups == want + [by_shape[k] for k in sorted(by_shape)]
    assert any(len(g) == 1 for g in groups)
    decoded.clear()
    mine = [g[min(1, len(g) - 1)] for g in groups]
    items = list(loader.subset(mine))
    assert decoded == [test_roidb[i]["image"] for i in mine]
    assert [it[0] for it in items] == [test_roidb[i]["image_id"] for i in mine]


def test_dryrun_multichip_two_ranks():
    """The counterpart of __graft_entry__.py::dryrun_multichip on two gloo
    ranks: three tiny families, each DP step within 5% (relative L2) of
    the one-process update, the losses within 1e-3."""
    from relation_tpu_torch.entry import dryrun_multichip
    out = dryrun_multichip(2)
    assert set(out) == {"c4-flagship", "fpn", "dcn"}
    assert all(v["global_rel"] < 1e-3 for v in out.values())


def test_make_mesh_and_shard_batch():
    """One process without a distributed environment is a mesh of one rank
    (no group); shard_batch cuts every entry into equal shares by rank and
    refuses a batch that does not divide; the backend and n_data are
    checked."""
    assert "WORLD_SIZE" not in os.environ or os.environ["WORLD_SIZE"] == "1"
    one = make_mesh(device="cpu")
    assert (one.rank, one.world, one.group, one.distributed) == (0, 1, None, False)
    batch = {"image": np.arange(12).reshape(4, 3),
             "im_info": torch.arange(8).reshape(4, 2)}
    assert shard_batch(one, batch)["image"].shape == (4, 3)
    second = Mesh(rank=1, world=2, device=torch.device("cpu"))
    got = shard_batch(second, batch)
    np.testing.assert_array_equal(got["image"], batch["image"][2:])
    assert torch.equal(got["im_info"], batch["im_info"][2:])
    with pytest.raises(ValueError, match="rows"):
        shard_batch(Mesh(rank=0, world=3, device=torch.device("cpu")), batch)
    with pytest.raises(ValueError, match="n_data"):
        make_mesh(n_data=2, device="cpu")
    with pytest.raises(ValueError, match="nccl"):
        make_mesh(backend="nccl", device="cpu")
