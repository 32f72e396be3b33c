"""The train step's ``stop_after`` cuts and TPU.LNMS_REMAT
(relation_tpu_torch/core/trainer.py) against the JAX package's step
(relation_tpu/core/trainer.py:175-381).

Each cut's metrics are held against the JAX step's forward (``no_grad``) on
the tiny plain_learn_nms model (synth_params), the fixed batch of
tests/test_golden_train.py and the anchor priorities the JAX step draws, with
the JAX model's geometric bias on its jnp reference (exact sin/cos, as in
tests/test_torch_train.py): 1e-4 relative, the band of the whole step's
metrics there. Then each cut trains: its step moves the parameters its
partial loss reaches. The remat step (the learned-NMS branch recomputed in
the backward) is held to the plain step: metrics and every leaf's update
within 1e-6 of the plain step's.
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
        "lnms_score", "lnms_target"]


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
        cut in ("head", "lnms_score", "lnms_target"))


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
