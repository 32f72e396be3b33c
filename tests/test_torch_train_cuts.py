"""The train step's ``stop_after`` cuts, the learned-NMS head's probes and
TPU.LNMS_REMAT (relation_tpu_torch/core/trainer.py,
relation_tpu_torch/models/learn_nms.py) against the JAX package's step
(relation_tpu/core/trainer.py:175-381) and head
(relation_tpu/models/learn_nms.py:67-166).

Each cut's metrics are held against the JAX step's forward (``no_grad``) on
the tiny plain_learn_nms model (synth_params), the fixed batch of
tests/test_golden_train.py and the anchor priorities the JAX step draws, with
the JAX model's geometric bias on its jnp reference (exact sin/cos, as in
tests/test_torch_train.py): 1e-4 relative, the band of the whole step's
metrics there. Then each cut trains: its step moves the parameters its
partial loss reaches. The remat step (the learned-NMS branch recomputed in
the backward) is held to the plain step: metrics and every leaf's update
within 1e-6 of the plain step's. The probes ('embed', 'attn') of the head
are held to JAX's at 1e-5, and the two cuts that take them (lnms_embed,
lnms_attn) train as JAX's do, dense or fully fused, with or without remat:
without weight decay, every leaf's momentum trace (its first gradient, the
1e-30 taps' included) in the band of tests/test_torch_rpn_workflow.py's
gradient check.
"""

import contextlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tests.test_golden_e2e import family_cfg, synth_params
from tests.test_golden_train import _fixed_batch
from tests.test_torch_helpers import port_model

CUTS = ["rpn", "anchor_targets", "proposals", "sample", "feat", "pool", "head",
        "lnms_embed", "lnms_attn", "lnms_score", "lnms_target"]
# the cuts that add the 1e-30 terms of the learned-NMS branch to the metrics
TAPPED = ("nms_pos_loss", "nms_neg_loss", "nms_acc_pos", "nms_acc_neg")


@contextlib.contextmanager
def _exact_trig_jax():
    import relation_tpu.models.relation as jrel
    import relation_tpu.ops.pallas.geom_bias as jgb
    saved = (jrel.fused_geometric_bias, jgb.fused_geometric_bias)

    def bias_ref(pos, k, b, scale=100.0):
        return jgb.geom_bias_reference(pos, k, b, scale)
    jrel.fused_geometric_bias = jgb.fused_geometric_bias = bias_ref
    try:
        yield
    finally:
        jrel.fused_geometric_bias, jgb.fused_geometric_bias = saved


def _jax_priorities(cfg, batch):
    """The anchor uniforms of the JAX step at step 0 (fold_in -> split(B)
    -> split -> r_anchor -> split -> (fg, bg))."""
    B, size = batch["image"].shape[0], batch["image"].shape[1]
    K = (size // 16) ** 2 * int(cfg.network.NUM_ANCHORS)
    rngs = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), 0), B)
    out = []
    for b in range(B):
        k_fg, k_bg = jax.random.split(jax.random.split(rngs[b])[0])
        out.append({"anchor": (np.array(jax.random.uniform(k_fg, (K,))),
                               np.array(jax.random.uniform(k_bg, (K,))))})
    return out


@pytest.fixture(scope="module")
def setup():
    from relation_tpu.core.trainer import build_model, create_train_state
    cfg = family_cfg("plain_learn_nms")
    with _exact_trig_jax():
        model = build_model(cfg, tiny=True)
        state = create_train_state(model, cfg, jax.random.PRNGKey(0),
                                   jnp.zeros((64, 64, 3)),
                                   jnp.asarray([64.0, 64.0, 1.0]))
    params = synth_params(jax.tree.map(
        lambda p: jax.ShapeDtypeStruct(p.shape, p.dtype), state.params))
    state = state.replace(params=params, opt_state=state.tx.init(params))
    return cfg, model, state, params, _fixed_batch()


def _port_step(cfg, params, batch, **kw):
    from relation_tpu_torch.core.trainer import (create_train_state,
                                                 make_train_step)
    model = port_model(cfg, params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(model, cfg)
    _, metrics = make_train_step(model, cfg, device="cpu", **kw)(
        state, batch, priorities=_jax_priorities(cfg, batch))
    moved = {k for k, v in model.state_dict().items()
             if not torch.equal(v, before[k])}
    return {k: float(v) for k, v in metrics.items()}, model, before, moved


@pytest.mark.parametrize("cut", CUTS)
def test_stop_after_cut_matches_jax(setup, cut):
    """The cut's metrics against the JAX cut's (forward only, 1e-4
    relative; the 1e-30 terms of the cuts after the RPN keep the JAX
    totals' values, so totals agree with the RPN losses'); then the port's
    cut trains without weight decay: the RPN moves, and the classifier
    only where the head's losses are in the cut (a 1e-30 term moves no
    weight of f32)."""
    from relation_tpu.core.trainer import make_train_step as j_step
    cfg, jm, jstate, params, batch = setup
    with _exact_trig_jax():
        _, want = jax.jit(j_step(jm, cfg, stop_after=cut, no_grad=True))(
            jstate, jax.tree.map(jnp.asarray, batch))
    want = {k: float(v) for k, v in want.items()}
    got, _, _, _ = _port_step(cfg, params, batch, stop_after=cut, no_grad=True)
    assert set(got) == set(want)
    for k, w in want.items():
        assert np.isfinite(got[k])
        assert got[k] == pytest.approx(w, rel=1e-4, abs=1e-7), (cut, k)
    no_decay = cfg.copy()
    no_decay.TRAIN.wd = 0.0                  # a leaf moves by its gradient only
    trained, _, _, moved = _port_step(no_decay, params, batch, stop_after=cut)
    assert trained == pytest.approx(got, rel=1e-6)
    assert any(k.startswith("rpn.") for k in moved)
    assert any(k.startswith("cls_score") for k in moved) == (
        cut in CUTS[CUTS.index("head"):])
    if cut in ("lnms_embed", "lnms_attn", "lnms_score"):
        # the branch's four metrics are its 1e-30 tap: held at 1e-4 / 1e-30
        for k in TAPPED:
            assert got[k] * 1e30 == pytest.approx(want[k] * 1e30, rel=1e-4), k


def test_lnms_remat_step_equals_the_plain_step(setup, monkeypatch):
    """TPU.LNMS_REMAT: the learned-NMS branch runs its forward again in the
    backward (two calls of the head a step, one without remat) and the
    step's metrics and every leaf's update equal the plain step's within
    1e-6 (the same operations on the same inputs)."""
    from relation_tpu_torch.models.learn_nms import LearnNMSHead
    cfg, _, _, params, batch = setup
    calls = []
    forward = LearnNMSHead.forward

    def counted(self, *a, **kw):
        calls.append(torch.is_grad_enabled())
        return forward(self, *a, **kw)
    monkeypatch.setattr(LearnNMSHead, "forward", counted)
    plain, pm, before, moved = _port_step(cfg, params, batch)
    n_plain = len(calls)
    rcfg = cfg.copy()
    rcfg.TPU.LNMS_REMAT = True
    remat, rm, _, rmoved = _port_step(rcfg, params, batch)
    assert n_plain == 2 and len(calls) - n_plain == 4     # two images
    assert set(remat) == set(plain) and moved == rmoved
    for k, v in plain.items():
        assert remat[k] == pytest.approx(v, rel=1e-6, abs=1e-12), k
    psd, rsd = pm.state_dict(), rm.state_dict()
    for k in psd:
        d_plain = psd[k] - before[k]
        np.testing.assert_allclose((rsd[k] - before[k]).numpy(), d_plain.numpy(),
                                   rtol=0, atol=1e-6 * float(d_plain.abs().max())
                                   + 1e-12, err_msg=k)


def _head_inputs(cfg, N=24, seed=3):
    """Seeded inputs of the learned-NMS head: cls_score [N, K], bbox_pred
    [N, 8], rois [N, 4] inside a 64x64 image, roi_feat [N, 64], im_info."""
    r = np.random.RandomState(seed)
    K = int(cfg.dataset.NUM_CLASSES)
    xy = r.uniform(0, 40, (N, 2))
    rois = np.concatenate([xy, xy + r.uniform(6, 24, (N, 2))], 1)
    return (r.randn(N, K).astype(np.float32) * 2,
            r.randn(N, 8).astype(np.float32) * 0.2,
            rois.astype(np.float32),
            r.randn(N, 64).astype(np.float32),
            np.asarray([64.0, 64.0, 1.0], np.float32))


@pytest.mark.parametrize("probe", ["", "embed", "attn"])
def test_learn_nms_probe_matches_jax(setup, probe):
    """LearnNMSHead(probe=) against JAX's learn_nms(probe=) on the same
    inputs at 1e-5: the sorted scores and boxes, and the conditional score
    (for a probe its 1e-30 tap, held at 1e-5 / 1e-30); an unknown probe
    raises in the port (JAX runs the whole head for one)."""
    from relation_tpu.models.detector import RelationRCNN as JRCNN
    from tests.test_torch_helpers import n, t
    cfg, jm, _, params, _ = setup
    ins = _head_inputs(cfg)
    with _exact_trig_jax():
        want = jm.apply({"params": params}, *map(jnp.asarray, ins),
                        probe=probe, method=JRCNN.learn_nms)
    model = port_model(cfg, params)
    with torch.no_grad():
        got = model.learn_nms(*map(t, ins), probe=probe)
    assert set(got) == set(want)
    scale = 1e30 if probe else 1.0
    for k in ("sorted_score", "sorted_bbox", "nms_conditional_score",
              "nms_multi_score"):
        g = n(got[k]) * (scale if k == "nms_conditional_score" else 1.0)
        w = np.asarray(want[k]) * (scale if k == "nms_conditional_score" else 1.0)
        assert g.shape == w.shape and np.isfinite(g).all(), k
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=k)
    if probe:
        z = n(got["nms_conditional_score"])
        assert (z == z.flat[0]).all() and 0 < abs(z.flat[0]) < 1e-20
    with pytest.raises(ValueError, match="probe"):
        model.learn_nms(*map(t, ins), probe="logit")


def _jax_trace(opt_state) -> dict:
    """The momentum trace of the JAX optimizer's sgd, flattened."""
    import optax
    from tests.test_torch_helpers import flat_numpy
    found = []
    jax.tree.map(lambda x: found.append(x.trace), opt_state,
                 is_leaf=lambda x: isinstance(x, optax.TraceState))
    return flat_numpy(found[0])


@pytest.fixture(scope="module")
def jax_probe_steps(setup):
    """cut -> (metrics, momentum trace) of one JAX train step without weight
    decay at each probe cut (compiled once per cut for the file)."""
    from relation_tpu.core.trainer import (make_optimizer, make_train_step,
                                           trainable_mask)
    cfg, jm, jstate, params, batch = setup
    cfg = cfg.copy()
    cfg.TRAIN.wd = 0.0
    tx = make_optimizer(cfg, 1000, trainable_mask(
        params, tuple(cfg.network.FIXED_PARAMS)))
    state = jstate.replace(tx=tx, opt_state=tx.init(params))
    done = {}

    def run(cut):
        if cut not in done:
            with _exact_trig_jax():
                state2, m = jax.jit(make_train_step(jm, cfg, stop_after=cut))(
                    state, jax.tree.map(jnp.asarray, batch))
            done[cut] = ({k: float(v) for k, v in m.items()},
                         _jax_trace(state2.opt_state))
        return cfg, done[cut]
    return run


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("attention", ["dense", "fully_fused"])
@pytest.mark.parametrize("cut", ["lnms_embed", "lnms_attn"])
def test_lnms_probe_step_matches_jax(setup, jax_probe_steps, cut, attention,
                                     remat):
    """One step of each probe cut, with the dense learned-NMS attention or
    the fully fused one (its plain version on the CPU), with or without
    TPU.LNMS_REMAT, against the JAX step (dense, no remat: the same
    function) without weight decay: every metric at 1e-4 relative (the
    branch's 1e-30 terms at 1e-4 / 1e-30), and every trainable leaf's
    momentum trace, its gradient, in the bands of the whole step's update
    (test_torch_train.py::test_train_step_matches_jax_and_golden: 1e-3
    relative plus 1e-6, 5e-6 for pair_pos_fc1, over the learning rate);
    the learned-NMS leaves, whose gradients are the 1e-30 taps', at 1e-3
    relative plus 1e-4 of the leaf's largest element (5e-4 for
    pair_pos_fc1). The branch's gradient is the 1e-30 tap of the 1e-30
    tap inside the head (1e-60: zero in f32), so every learned-NMS leaf's
    trace is zero in both packages; in the port the backward still reaches
    the leaves before the probe (autograd hands them a gradient) and none
    past it."""
    from relation_tpu_torch.convert import to_jax_params
    from relation_tpu_torch.core.trainer import (create_train_state,
                                                 make_train_step)
    _, _, _, params, batch = setup
    cfg, (want, j_trace) = jax_probe_steps(cut)
    cfg = cfg.copy()
    cfg.TPU.LNMS_REMAT = remat
    model = port_model(cfg, params)
    model.learn_nms_head.NMSRelationModule_0.fully_fused = (
        attention == "fully_fused")
    state = create_train_state(model, cfg)
    delivered = set()
    hooks = [p.register_post_accumulate_grad_hook(
        lambda _p, k=k: delivered.add(k.split(".")[1]))
        for k, p in model.named_parameters() if k.startswith("learn_nms_head.")]
    try:
        state, m = make_train_step(model, cfg, stop_after=cut, device="cpu")(
            state, batch, priorities=_jax_priorities(cfg, batch))
    finally:
        for h in hooks:
            h.remove()
    got = {k: float(v) for k, v in m.items()}
    assert set(got) == set(want)
    for k, w in want.items():
        assert np.isfinite(got[k])
        if k in TAPPED:
            assert got[k] * 1e30 == pytest.approx(w * 1e30, rel=1e-4), k
        else:
            assert got[k] == pytest.approx(w, rel=1e-4, abs=1e-7), k
    trace = to_jax_params(state.trace)
    assert set(trace) <= set(j_trace)
    lr = float(cfg.TRAIN.lr)
    for k, g in trace.items():
        w = j_trace[k]
        band = 5.0 if "pair_pos_fc1" in k else 1.0
        atol = (band * 1e-4 * float(np.abs(w).max()) if "learn_nms_head" in k
                else band * 1e-6 / lr)
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=atol, err_msg=k)
        if "learn_nms_head" in k:
            assert not np.any(g) and not np.any(w), k
    assert delivered == {"lnms_embed": {"nms_rank", "roi_feat_embedding"},
                         "lnms_attn": {"nms_rank", "roi_feat_embedding",
                                       "NMSRelationModule_0"}}[cut]
