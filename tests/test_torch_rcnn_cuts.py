"""The RCNN-only step's ``stop_after`` cuts
(relation_tpu_torch/core/rpn_workflow.py::make_train_step_rcnn) against the
JAX package's (relation_tpu/core/rpn_workflow.py:263-370): 'trunk',
'sample', 'pool' and 'head' on the tiny fpn_learn_nms model under
train_shared (the setup of tests/test_torch_rpn_workflow.py::
test_rcnn_step_matches_jax), and 'pool' in sampled mode, where the sampler
draws.

Each cut's metrics are held at 1e-4 relative (a cut that is only a 1e-30
tap at 1e-4 / 1e-30: the sums of its feature maps, its sampled targets or
its pooled features), and every leaf's update in the bands of the end-to-end
step. The sampler draws from the generator as the full step does up to the
cut. Last, the cut-profile tool (relation_tpu_torch/tools/train_cuts.py)
runs its legs on the tiny trunk on the CPU.
"""

import numpy as np
import pytest
import jax
import torch

import relation_tpu.core.rpn_workflow as jw
import relation_tpu_torch.core.rpn_workflow as tw
from tests.test_golden_e2e import family_cfg
from tests.test_torch_checkpoint import _jax_state
from tests.test_torch_helpers import flat_numpy, jax_tiny_family, port_model
from tests.test_torch_rpn_workflow import (J, RCNN_CASES, _assert_step_matches,
                                           _rcnn_batch, _step_keys, _trainable)
from tests.test_torch_train import _exact_trig_jax

PURE_TAPS = ("trunk", "sample", "pool")


def _case_cfg(case):
    name, shared_prefixes, stats = RCNN_CASES[case]
    cfg = family_cfg(name)
    if stats is not None:
        cfg.TRAIN.LEARN_NMS = cfg.TEST.LEARN_NMS = False
        cfg.TRAIN.ENABLE_OHEM = False
        cfg.TRAIN.BATCH_ROIS = 16
        cfg.TRAIN.BBOX_NORMALIZATION_PRECOMPUTED = False
    if shared_prefixes is not None:
        cfg.network.FIXED_PARAMS_SHARED = shared_prefixes
    return cfg, shared_prefixes is not None, stats


@pytest.mark.parametrize("case,cut", [
    ("fpn_learn_nms_train_shared", "trunk"),
    ("fpn_learn_nms_train_shared", "sample"),
    ("fpn_learn_nms_train_shared", "pool"),
    ("fpn_learn_nms_train_shared", "head"),
    ("sampled_custom_stats", "pool")])
def test_rcnn_cut_matches_jax(case, cut):
    from relation_tpu_torch.convert import to_jax_params
    from relation_tpu_torch.core.trainer import create_train_state, refreeze_state
    cfg, shared, stats = _case_cfg(case)
    fixed = cfg.network.FIXED_PARAMS_SHARED if shared else cfg.network.FIXED_PARAMS
    _, params = jax_tiny_family(cfg)
    batch = _rcnn_batch()
    B, R = batch["rois"].shape[:2]
    G = batch["gt_boxes"].shape[1]
    kw = dict(max_rois=R, max_gt=G, train_shared=shared, stop_after=cut)
    if stats is not None:
        kw.update(bbox_means=stats[0], bbox_stds=stats[1])
    with _exact_trig_jax():
        jmodel = jax_tiny_family(cfg)[0]
        state2, jm = jax.jit(jw.make_train_step_rcnn(jmodel, cfg, **kw))(
            _jax_state(cfg, params, fixed), jax.tree.map(J, batch))
    prio = [{} if stats is None else {"sample": tuple(
        np.array(jax.random.uniform(k, (R + G,)))
        for k in jax.random.split(key, 4))} for key in _step_keys(B)]
    model = port_model(cfg, params)
    pstate = create_train_state(model, cfg)
    if shared:
        pstate = refreeze_state(pstate, cfg, cfg.network.FIXED_PARAMS_SHARED)
    pstate, m = tw.make_train_step_rcnn(model, cfg, device="cpu", **kw)(
        pstate, batch, priorities=prio)
    metrics = {k: float(v) for k, v in m.items()}
    want = {k: float(v) for k, v in jm.items()}
    if cut in PURE_TAPS:
        assert set(metrics) == set(want) == {"total_loss"}
        assert 0 < abs(metrics["total_loss"]) <= 1e-20
        assert metrics["total_loss"] * 1e30 == pytest.approx(
            want["total_loss"] * 1e30, rel=1e-4)
    else:
        assert "nms_pos_loss" not in metrics and "rcnn_acc" in metrics
    before, after = flat_numpy(params), to_jax_params(model.state_dict())
    _assert_step_matches(cfg, metrics, want, before, after,
                         flat_numpy(state2.params), _trainable(params, fixed))


@pytest.mark.parametrize("cut", ["trunk", "sample", "pool", "head"])
def test_rcnn_cut_draws_as_the_full_step(cut):
    """With the sampler drawing from the state's generator (sampled mode):
    a cut at or after 'sample' leaves the generator where the full step
    leaves it, 'trunk' (no sampling) where it found it; the cut's loss is
    finite and, for a pure tap, at most 1e-20."""
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.trainer import build_model, create_train_state
    cfg, _, _ = _case_cfg("sampled_custom_stats")
    model = init_params(build_model(cfg, tiny=True, device="cpu"), seed=1)
    batch = _rcnn_batch()

    def after(stop_after):
        init_params(model, seed=1)
        state = create_train_state(model, cfg, seed=5)
        start = state.generator.get_state()
        _, m = tw.make_train_step_rcnn(model, cfg, 20, 4, stop_after=stop_after,
                                       device="cpu")(state, batch)
        return start, state.generator.get_state(), float(m["total_loss"])
    start, full, _ = after("")
    _, cut_state, loss = after(cut)
    assert np.isfinite(loss)
    assert torch.equal(cut_state, start if cut == "trunk" else full)
    assert not torch.equal(full, start)
    if cut in PURE_TAPS:
        assert 0 < abs(loss) <= 1e-20


@pytest.mark.parametrize("argv,names", [
    (["--cuts", "rpn", "lnms_attn", "full"], ["rpn", "lnms_attn", "full"]),
    (["--family", "fpn", "--mode", "bwd", "--legs", "f_head", "f_all",
      "fwd_only"], ["f_head", "f_all", "fwd_only"])])
def test_train_cuts_tool_rehearses_on_the_cpu(argv, names, capsys):
    """relation_tpu_torch/tools/train_cuts.py on the tiny trunk on the CPU:
    the legs asked for, in order, each a finite host time, and the
    per-stage deltas between them."""
    from relation_tpu_torch.tools import train_cuts
    res = train_cuts.main(["--device", "cpu", "--tiny", "--steps", "1",
                           "--rounds", "2", "--set", "TRAIN.lr=2e-5"] + argv)
    assert [name for _, name in res] == names
    assert all(np.isfinite(h) and h > 0 for h, _, _ in res.values())
    out = capsys.readouterr().out
    assert "cfg override: TRAIN.lr = 2e-05" in out
    assert ("per-stage deltas" in out
            and out.count(" ms  events (host-synced) ") == len(names) - 1)


def test_run_step_differentiates_every_loss_but_a_cut_without_parameters():
    """run_step (the body of every train step) takes the loss's backward:
    a loss without a graph raises, unless the step says its loss reaches no
    parameter (the RCNN step's 'sample' cut) or its mask trains no leaf
    (the cut tool's f_all leg), where the update runs on zero gradients, as
    JAX's does."""
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.predictor import pixel_means_tensor
    from relation_tpu_torch.core.trainer import (build_model, create_train_state,
                                                 run_step, trainable_mask)
    cfg, _, _ = _case_cfg("sampled_custom_stats")
    model = init_params(build_model(cfg, tiny=True, device="cpu"), seed=1)
    state = create_train_state(model, cfg, seed=5)

    def per_image(_feat, _rpn, _ins, _prio):
        total = torch.full((), 1e-30)
        return total, {"total_loss": total}

    def draw(_rpn, _ins, n_images, _generator):
        return [{} for _ in range(n_images)]
    kw = dict(step_mask=trainable_mask(model, tuple(cfg.network.FIXED_PARAMS)),
              no_grad=False, device=torch.device("cpu"),
              pixel_means=pixel_means_tensor(cfg, "cpu"), draw=draw)
    with pytest.raises(RuntimeError, match="grad"):
        run_step(model, state, _rcnn_batch(), None, per_image, **kw)
    assert state.count == 0
    state, m = run_step(model, state, _rcnn_batch(), None, per_image,
                        reaches_params=False, **kw)
    assert state.count == 1 and float(m["total_loss"]) == pytest.approx(1e-30)
    kw["step_mask"] = trainable_mask(model, ("",))
    assert not any(kw["step_mask"].values())
    state, _ = run_step(model, state, _rcnn_batch(), None, per_image, **kw)
    assert state.count == 2


def test_busy_by_leg_clips_and_merges_the_device_spans():
    """train_cuts.busy_by_leg: each step window's device busy time is the
    union of the device spans clipped to the window; the profiler's device
    copy of a window and the host's ops count for nothing."""
    from types import SimpleNamespace
    from relation_tpu_torch.tools import train_cuts
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(name, dev, s, e):
        return SimpleNamespace(name=name, device_type=dev,
                               time_range=SimpleNamespace(start=s, end=e))
    mark = train_cuts.MARK
    events = [ev(mark + "a", cpu, 0, 100), ev(mark + "a", cuda, 5, 95),
              ev("k1", cuda, 10, 30), ev("k2", cuda, 20, 40),
              ev("k3", cuda, 90, 120), ev(mark + "b", cpu, 200, 300),
              ev("k4", cuda, 150, 210), ev("op", cpu, 210, 290),
              ev("k5", cuda, 250, 260), ev(mark + "a", cpu, 400, 500)]
    got = train_cuts.busy_by_leg(torch, SimpleNamespace(events=lambda: events))
    assert got == {"a": [pytest.approx(0.040), 0.0],
                   "b": [pytest.approx(0.020)]}
