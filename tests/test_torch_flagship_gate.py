"""The production-shape gate (relation_tpu_torch/tools/flagship_golden.py,
tests/flagship_port_golden.py, tests/golden/flagship_port.npz).

- The generator's and the checker's code at the tiny proposal counts, on
  the tiny trunk and a 64x128 image: the JAX package's detections and trunk
  feature on the calibrated init_params weights, and the port's plain path
  on the CPU inside the bands of tools/flagship_golden.py and its trunk band
  against them.
- The calibration (relation_tpu_torch/tools/calibrate.py): the factors that
  calibrate_heads applies are the ones it returns, and apply_factors
  repeats them by the one numpy expression the golden and the check share.
- The committed file well-formed.
- Its full regeneration against the committed file (``slow``: the
  full-depth flagship at 608x1024 on the CPU, about two minutes).
"""

import numpy as np
import pytest
import torch

from relation_tpu_torch.tools import calibrate
from relation_tpu_torch.tools import flagship_golden as gate
from tests import flagship_port_golden as gen

TINY = dict(tiny=True, size=(64, 128))


@pytest.fixture(scope="module")
def tiny_golden():
    return gen.golden_arrays(**TINY)


def test_gate_code_passes_its_bands_at_tiny_shapes(tiny_golden):
    """The port's plain path against the JAX package's detections on the
    same calibrated weights: every golden top-50 detection matched at IoU
    >= 0.95 and |score delta| <= 2e-2, the mean top-50 score within 5e-3
    relative, the count within max(2, 5%)."""
    g = tiny_golden
    assert len(g["dets"]) > gate.TOP_K
    new = gate.port_dets(g["factors"], device="cpu", **TINY)
    errs, margins = gate.compare(new, g["dets"], int(g["n_dets"]),
                                 float(g["mean_top50"]))
    assert errs == [], (errs, margins)
    assert margins["worst_iou"] >= gate.IOU_MIN


def test_gate_trunk_code_holds_its_band_at_tiny_shapes(tiny_golden):
    """The port's trunk feature in the flagship's own configuration against
    the JAX package's at the rows and columns trunk_sample reads, inside
    TRUNK_RTOL; the feature shifted by a tenth of its mean misses it."""
    g = tiny_golden
    new = gate.port_trunk(g["factors"], device="cpu", **TINY)
    assert new.shape == g["trunk_bf16"].shape and np.isfinite(new).all()
    errs, rel = gate.hold_trunk(new, g["trunk_bf16"])
    assert errs == [] and rel <= gate.TRUNK_RTOL
    errs, _ = gate.hold_trunk(new + 0.1 * np.abs(new).mean(), g["trunk_bf16"])
    assert errs


def test_gate_bands_catch_a_moved_box(tiny_golden):
    """A golden box moved by a fifth of its width, or a score shifted
    past the band, is a miss."""
    g = tiny_golden
    moved = g["dets"].copy()
    moved[0, 2:6:2] += 0.2 * (moved[0, 4] - moved[0, 2] + 1)
    errs, _ = gate.compare(moved, g["dets"], int(g["n_dets"]),
                           float(g["mean_top50"]))
    assert any("top-0" in e for e in errs)
    shifted = g["dets"].copy()
    shifted[:, 1] *= 1.01
    errs, _ = gate.compare(shifted, g["dets"], int(g["n_dets"]),
                           float(g["mean_top50"]))
    assert errs and all("mean" in e for e in errs)


def test_factors_are_one_host_product(tiny_golden):
    """apply_factors writes weight * np.float32(factor) in f32, bit for bit,
    into the four calibrated layers and nothing else."""
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.trainer import build_model
    cfg = gate.gate_cfg(tiny=True)
    fresh = init_params(build_model(cfg, tiny=True, device="cpu"), gate.SEED)
    before = {k: v.clone() for k, v in fresh.state_dict().items()}
    factors = tiny_golden["factors"]
    calibrate.apply_factors(fresh, factors)
    after = fresh.state_dict()
    scaled = {f"{name}.weight": f
              for (name, _), f in zip(calibrate.CALIBRATED, factors)}
    for k, v in after.items():
        if k in scaled:
            want = before[k].numpy() * np.float32(scaled[k])
            np.testing.assert_array_equal(v.numpy(), want, err_msg=k)
            assert not torch.equal(v, before[k])
        else:
            assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("family", ["flagship", "fpn_learn_nms"])
def test_calibrate_heads_returns_the_factors_it_applied(family):
    """calibrate_heads scales the four layers in place and returns their
    factors, finite and positive: apply_factors on a fresh copy of the
    weights gives the calibrated model's state bit for bit (an FPN's RPN
    head, run on five levels, scaled once)."""
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.predictor import build_predict_fn
    from relation_tpu_torch.core.trainer import build_model
    from relation_tpu_torch.entry import family_cfg
    cfg = family_cfg(family, tiny_shapes=True)

    def fresh():
        return init_params(build_model(cfg, tiny=True, device="cpu"), seed=0)
    model = fresh()
    factors = calibrate.calibrate_heads(
        model, build_predict_fn(model, cfg),
        torch.from_numpy(gate.gate_image((64, 128))), torch.tensor(gate.IM_INFO))
    assert factors.shape == (4,) and factors.dtype == np.float32
    assert np.isfinite(factors).all() and (factors > 0).all()
    assert not np.allclose(factors, 1.0)
    again = calibrate.apply_factors(fresh(), factors).state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, again[k]), k


def test_committed_golden_is_well_formed():
    """Four finite positive factors, the detections sorted by score with
    real classes, n_dets and mean_top50 consistent with them."""
    with np.load(gate.GOLDEN) as z:
        assert set(z.files) == {"dets", "n_dets", "mean_top50", "factors",
                                "trunk_bf16", "cfg"}
        dets, factors, trunk = z["dets"], z["factors"], z["trunk_bf16"]
        assert str(z["cfg"]) == gen.CFG_NAME
        assert factors.shape == (4,) and factors.dtype == np.float32
        assert np.isfinite(factors).all() and (factors > 0).all()
        assert dets.ndim == 2 and dets.shape[1] == 6 and dets.dtype == np.float32
        assert int(z["n_dets"]) == len(dets) > gate.TOP_K
        assert np.isfinite(dets).all()
        assert (dets[:, 0] >= 1).all() and (dets[:, 0] <= 80).all()
        assert (np.diff(dets[:, 1]) <= 0).all()
        assert (dets[:, 4] > dets[:, 2]).all() and (dets[:, 5] > dets[:, 3]).all()
        assert float(z["mean_top50"]) == pytest.approx(
            float(dets[:gate.TOP_K, 1].mean()), rel=1e-6)
        # the head's feature of the 38x64 map at rows 0, 8, .., 32, 37 and
        # columns 0, 8, .., 56, 63
        assert trunk.shape == (6, 9, 256) and trunk.dtype == np.float32
        assert np.isfinite(trunk).all() and np.abs(trunk).mean() > 0


@pytest.mark.slow
def test_regeneration_matches_the_committed_golden():
    """The full generator at 608x1024 on the CPU: the factors within 1e-5
    relative of the committed ones, the JAX detections within the gate's
    bands of the committed file and as many, its bf16 trunk sample within
    1e-3 of the committed one."""
    fresh = gen.golden_arrays()
    with np.load(gate.GOLDEN) as z:
        np.testing.assert_allclose(fresh["factors"], z["factors"], rtol=1e-5)
        assert int(fresh["n_dets"]) == int(z["n_dets"])
        errs, _ = gate.compare(fresh["dets"], z["dets"], int(z["n_dets"]),
                               float(z["mean_top50"]))
        assert gate.trunk_error(fresh["trunk_bf16"], z["trunk_bf16"]) <= 1e-3
    assert errs == []
