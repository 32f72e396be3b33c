"""The reference-weights path of the port: its ``mx.nd.save`` reader and
converter (relation_tpu_torch/tools/convert_reference_params.py) against the
repository's JAX converter (tools/convert_reference_params.py) on files
written by tests/test_convert_params.py::write_mx_nd_save, and the test
driver's parity mode (relation_tpu_torch/experiments/test.py) against the
JAX driver's (experiments/test.py:143-161). Arrays are compared bit for bit:
both converters only move and reshape them."""

import sys

import numpy as np
import pytest
from flax.traverse_util import flatten_dict

import tools.convert_reference_params as jconv
from relation_tpu_torch.convert import from_jax_params
from relation_tpu_torch.core import checkpoint as tck
from relation_tpu_torch.tools import convert_reference_params as tconv
from tests.test_convert_params import FLAGSHIP_NAMES, write_mx_nd_save
from tests.test_golden_e2e import family_cfg
from tests.test_torch_helpers import jax_tiny_family, n, port_model

PARITY_KEYS = ("ROI_METHOD", "FPN_TOPK", "GEOM_EMB_DTYPE",
               "NMS_COMPACT_CLASSES", "DCN_POOL_DTYPE")


def _named_arrays(rng):
    return {"arg:conv1_weight": rng.randn(4, 3, 7, 7).astype(np.float32),
            "aux:bn_conv1_moving_var": rng.rand(4).astype(np.float32),
            "arg:fc_new_1_weight": rng.randn(6, 49 * 2).astype(np.float32),
            "arg:step": np.arange(5, dtype=np.int64),
            "arg:half": rng.randn(2, 3).astype(np.float16),
            "aux:scalar": np.asarray(2.5, np.float64)}


@pytest.mark.parametrize("version", ["v2", "v1", "legacy"])
def test_mx_reader_matches_jax_on_every_format(tmp_path, version):
    """Each format version of mxnet 1.x's NDArray::Save: the port's reader
    returns JAX's arrays (names, dtypes, shapes, bits), and its writer
    writes the test's bytes."""
    rng = np.random.RandomState(0)
    named = _named_arrays(rng)
    path = str(tmp_path / f"{version}.params")
    write_mx_nd_save(path, named, version=version)
    got = tconv.load_mxnet_params(path)
    want = jconv.load_mxnet_params(path)
    assert list(got) == list(want) == list(named)
    for k in named:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    mine = str(tmp_path / "mine.params")
    tconv.save_mxnet_params(mine, named, version=version)
    with open(path, "rb") as a, open(mine, "rb") as b:
        assert a.read() == b.read()


def test_mx_reader_rejects_a_bad_magic(tmp_path):
    path = tmp_path / "bad.params"
    path.write_bytes(b"\x00" * 64)
    with pytest.raises(ValueError, match="magic"):
        tconv.load_mxnet_params(str(path))
    with pytest.raises(ValueError, match="magic"):
        jconv.load_mxnet_params(str(path))


def _raw_for(model, rng, drop=2):
    """Random arrays under every reference name of ``model`` (MXNet
    layouts), the last ``drop`` names (sorted) left out, bbox_pred shadows
    and an array no leaf takes added."""
    sd = model.state_dict()
    names = sorted(tck.reference_name_map(model).items())
    raw = {}
    for mx, (key, tag) in names[:-drop]:
        shape = tuple(sd[key].shape)
        if tag == "dense_chw" or tag in ("conv", "dense", "raw"):
            arr = rng.randn(*shape)
        else:                                   # grouped [G, F, E]
            g, f, e = shape
            arr = rng.randn(g * e, f, 1, 1)
        prefix = "aux:" if "moving" in mx else "arg:"
        raw[prefix + mx] = arr.astype(np.float32)
    raw["arg:bbox_pred_weight_test"] = rng.randn(
        *raw["arg:bbox_pred_weight"].shape).astype(np.float32)
    raw["arg:bbox_pred_bias_test"] = rng.randn(
        *raw["arg:bbox_pred_bias"].shape).astype(np.float32)
    raw["arg:unused_extra_weight"] = rng.randn(3).astype(np.float32)
    return raw, [mx for mx, _ in names[-drop:]]


@pytest.mark.parametrize("test_weights", [False, True])
def test_converted_model_equals_jax_convert(tmp_path, test_weights):
    """An mx.nd.save file of every reference name of the tiny flagship
    (two names left out, the bbox_pred *_test shadows and an unknown array
    added), read and converted by each package with the same template: the
    port's state_dict equals JAX's convert output through from_jax_params
    leaf for leaf, with and without --use-test-weights; both list the same
    number of leaves left at the template and the same unused names. The
    CLI, on a file of a model built from a YAML, writes a params file with
    JAX's meta that both packages read back to that model's arrays (the
    shadows in place of bbox_pred with --use-test-weights)."""
    import relation_tpu.core.checkpoint as jck
    cfg = family_cfg("plain_learn_nms")
    _, params = jax_tiny_family(cfg)
    model = port_model(cfg, params)
    raw, dropped = _raw_for(model, np.random.RandomState(1))
    path = str(tmp_path / "rcnn_coco-0008.params")
    write_mx_nd_save(path, raw)
    jparams, jmissing, junused = jconv.convert(
        jconv.load_mxnet_params(path), params, use_test_weights=test_weights)
    want = from_jax_params(flatten_dict(jparams, sep="/"), model)
    sd, missing, unused = tconv.convert(tconv.load_any(path), model,
                                        use_test_weights=test_weights)
    assert set(sd) == set(want)
    for k in want:
        np.testing.assert_array_equal(n(sd[k]), n(want[k]), err_msg=k)
    assert len(missing) == len(jmissing) == len(dropped)
    assert unused == junused == ["bbox_pred_bias_test", "bbox_pred_weight_test",
                                 "unused_extra_weight"]
    shadow = raw["arg:bbox_pred_weight_test" if test_weights
                 else "arg:bbox_pred_weight"]
    np.testing.assert_array_equal(n(sd["bbox_pred.weight"]), shadow)

    # the CLI, on a file of a model built from a YAML
    from tests.test_torch_drivers import TINY_YAML
    yaml = tmp_path / "tiny.yaml"
    yaml.write_text(TINY_YAML)
    ymodel = build_tiny(tck_load_config(str(yaml)), seed=7)
    arrays = tconv.reference_arrays(ymodel)
    arrays["arg:bbox_pred_weight_test"] = -arrays["arg:bbox_pred_weight"]
    arrays["arg:bbox_pred_bias_test"] = arrays["arg:bbox_pred_bias"] + 1.0
    src = tconv.save_mxnet_params(str(tmp_path / "y.params"), arrays)
    argv = ["--src", src, "--cfg", str(yaml), "--out",
            str(tmp_path / "out.msgpack"), "--tiny", "--device", "cpu"]
    out = tconv.main(argv + (["--use-test-weights"] if test_weights else []))
    assert out["missing"] == []
    blob, meta = tck.read_params_blob(out["out"])
    assert meta == {"source": "mxnet_reference", "roi_method": "pool",
                    "test_weights": str(test_weights).lower()}
    assert jck.read_checkpoint_meta(out["out"]) == meta
    jblob, _ = jck.read_params_blob(out["out"])
    from_jax = from_jax_params(
        {k: np.asarray(v) for k, v in flatten_dict(jblob, sep="/").items()},
        ymodel)
    mine = tck.params_from_blob(blob, ymodel)
    for k, v in ymodel.state_dict().items():
        if test_weights and k.startswith("bbox_pred."):
            v = -v if k.endswith("weight") else v + 1.0
        np.testing.assert_array_equal(n(mine[k]), n(v), err_msg=k)
        np.testing.assert_array_equal(n(from_jax[k]), n(v), err_msg=k)


def test_round_trip_and_the_flagship_names(tmp_path):
    """reference_arrays (the model in MXNet's names and layouts) written as
    mx.nd.save and converted back: bit-equal, nothing missing, nothing
    unused. The full-depth flagship (built without memory) names every
    leaf under the real checkpoint's names."""
    from relation_tpu_torch.config.defaults import load_config
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.trainer import build_model
    cfg = family_cfg("plain_learn_nms")
    model = init_params(build_model(cfg, tiny=True, device="cpu"), seed=3)
    path = tconv.save_mxnet_params(str(tmp_path / "m.params"),
                                   tconv.reference_arrays(model))
    fresh = init_params(build_model(cfg, tiny=True, device="cpu"), seed=4)
    sd, missing, unused = tconv.convert(tconv.load_any(path), fresh)
    assert missing == [] and unused == []
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(n(sd[k]), n(v), err_msg=k)

    flagship = build_model(load_config(
        "experiments/cfgs/resnet_v1_101_coco_trainvalminus_rcnn_end2end_"
        "relation_learn_nms_8epoch.yaml"), device="meta")
    names = {("aux:" if "moving" in mx else "arg:") + mx: key
             for mx, (key, _) in tck.reference_name_map(flagship).items()}
    assert len(names) == len(flagship.state_dict()) > 530
    assert set(FLAGSHIP_NAMES) <= set(names)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("roi_method", ["auto", "align", "pool"])
def test_parity_mode_sets_the_jax_drivers_keys(tmp_path, monkeypatch,
                                               roi_method):
    """Both test drivers on a params file tagged roi_method 'pool', stopped
    where they build the model: the port's config has the JAX config's
    ROI_METHOD, FPN_TOPK, GEOM_EMB_DTYPE, NMS_COMPACT_CLASSES and
    DCN_POOL_DTYPE, with --roi-method auto (the parity mode), align and
    pool (the tag overridden, the other keys left at the YAML's)."""
    import experiments.test as jtest
    import relation_tpu.core.trainer as jtrainer
    import relation_tpu_torch.core.trainer as ttrainer
    from relation_tpu_torch.config.defaults import load_config
    from relation_tpu_torch.core.checkpoint import save_params
    from relation_tpu_torch.experiments import test as ttest
    from relation_tpu_torch.tools.mini_coco import write_mini_coco
    from tests.test_torch_drivers import TINY_YAML
    monkeypatch.chdir(tmp_path)
    write_mini_coco("data/coco", {"minitest": [(48, 64)]}, seed=5)
    (tmp_path / "tiny.yaml").write_text(TINY_YAML)
    cfg = load_config("tiny.yaml")
    save_params("ref.msgpack", build_tiny(cfg),
                meta={"source": "mxnet_reference", "roi_method": "pool"})
    seen = {}

    def recorder(name):
        def build(cfg, *a, **kw):
            seen[name] = {k: cfg.TPU.get(k) for k in PARITY_KEYS}
            raise _Stop
        return build
    monkeypatch.setattr(jtrainer, "build_model", recorder("jax"))
    monkeypatch.setattr(ttrainer, "build_model", recorder("port"))
    argv = ["--cfg", "tiny.yaml", "--tiny", "--ckpt", "ref.msgpack",
            "--roi-method", roi_method]
    monkeypatch.setattr(sys, "argv", ["test.py"] + argv)
    with pytest.raises(_Stop):
        jtest.main()
    with pytest.raises(_Stop):
        ttest.main(argv + ["--device", "cpu"])
    assert seen["port"] == seen["jax"]
    assert seen["port"]["ROI_METHOD"] == ("pool" if roi_method == "auto"
                                          else roi_method)
    assert (seen["port"]["NMS_COMPACT_CLASSES"] == 0) == (roi_method == "auto")


def build_tiny(cfg, seed=0):
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.trainer import build_model
    return init_params(build_model(cfg, tiny=True, device="cpu"), seed=seed)


def tck_load_config(path):
    from relation_tpu_torch.config.defaults import load_config
    return load_config(path)
