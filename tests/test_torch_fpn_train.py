"""Port parity of the FPN train step: relation_tpu (JAX, CPU) against
relation_tpu_torch (PyTorch, CPU) on the same numpy inputs.

- one whole train step of fpn, fpn_relation and fpn_learn_nms on the tiny
  model of tests/test_golden_train.py (synth_params, _fixed_batch, 64x64),
  with the random anchor subsampling fed the uniforms the JAX step draws,
  against the JAX step run here and against the committed train goldens;
- the gradient of ``pool_pyramid`` (each ROI pooled at its own level and
  put back in its order) against the JAX package's pooled-at-every-level
  selection.

The tiny FPN model computes its geometric bias on the JAX package's XLA
branch (exact sin/cos, f32 embedding), the formula the port's kernels and
their plain versions implement.

The two frameworks' f32 convolutions round differently, so the proposals
of the two steps differ by up to ~4e-4 px on this batch (the decode is the
same arithmetic: on equal RPN outputs they are bit-equal,
tests/test_torch_fpn.py). With synth_params some ROI pairs of the relation
modules sit near the geometric bias's 1e-6 clamp (acc down to 1.5e-5 in
relation_1), where d log(acc) = d acc / acc turns that into percents of the
pair_pos_fc1 update and 1.7e-4 of fpn_learn_nms's nms_neg_loss. So the step
is held to the JAX step's band with the JAX step's proposals handed to it
(everything else the port's own), and whole, with its own proposals, to the
goldens' band and to the JAX step's proposals within 1e-3 px.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tests.test_golden_e2e import GOLDEN_DIR
from tests.test_golden_train import _fixed_batch
from tests.test_torch_helpers import n, port_model, t
from tests.test_torch_train import _update_stats, jax_step  # noqa: F401

J = jnp.asarray
FAMILIES = ["fpn", "fpn_relation", "fpn_learn_nms"]
FPN_STRIDES = (64, 32, 16, 8, 4)


def _fpn_priorities(cfg, batch, step=0):
    """The uniform vectors the JAX step draws for the anchor subsampling:
    fold_in(rng, step) -> split(B) -> split -> r_anchor -> split (fg, bg),
    over the anchors of the five levels (the tiny pyramid's level of stride
    s is size / s on a side)."""
    B, size = batch["image"].shape[0], batch["image"].shape[1]
    K = sum((size // s) ** 2 for s in FPN_STRIDES) * int(cfg.network.NUM_ANCHORS)
    rngs = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), step), B)
    out = []
    for b in range(B):
        r_anchor, _ = jax.random.split(rngs[b])
        k_fg, k_bg = jax.random.split(r_anchor)
        out.append({"anchor": (np.array(jax.random.uniform(k_fg, (K,))),
                               np.array(jax.random.uniform(k_bg, (K,))))})
    return out


def _jax_proposals(cfg, params, batch):
    """The proposals of the JAX step: its trunk and RPN on the batch, then
    generate_proposals_fpn with the step's settings, image by image."""
    import relation_tpu.models.fpn as jf
    from relation_tpu.core.trainer import build_model
    _, rpn = build_model(cfg, tiny=True).apply(
        {"params": params}, J(batch["image"]),
        method=jf.RelationRCNNFPN.features_and_rpn)
    out = []
    for b in range(batch["image"].shape[0]):
        level = {s: (rpn[s][0][b], rpn[s][1][b]) for s in FPN_STRIDES}
        anchors = jf.fpn_anchors({s: level[s][0].shape[:2] for s in FPN_STRIDES},
                                 tuple(cfg.network.ANCHOR_SCALES),
                                 tuple(cfg.network.ANCHOR_RATIOS))
        out.append(np.asarray(jf.generate_proposals_fpn(
            level, anchors, J(batch["im_info"][b]),
            int(cfg.TRAIN.RPN_PRE_NMS_TOP_N), int(cfg.TRAIN.RPN_POST_NMS_TOP_N),
            float(cfg.TRAIN.RPN_NMS_THRESH), float(cfg.TRAIN.RPN_MIN_SIZE),
            topk=str(cfg.TPU.get("FPN_TOPK", "exact")))[0]))
    return out


def _port_step(cfg, params, monkeypatch, proposals=None):
    """One port step; ``proposals`` (one [R, 4] array an image) stand in for
    the step's own. Returns (metrics, new params, the step's own
    proposals)."""
    import relation_tpu_torch.core.trainer as T
    from relation_tpu_torch.convert import to_jax_params
    model = port_model(cfg, params)
    state = T.create_train_state(model, cfg)
    batch = _fixed_batch()
    own = []

    def propose(*args):
        out = T_propose(*args)
        own.append(n(out[0]))
        return out if proposals is None else (t(proposals[len(own) - 1]),) + out[1:]
    T_propose = T.generate_proposals_fpn
    monkeypatch.setattr(T, "generate_proposals_fpn", propose)
    state, metrics = T.make_train_step(model, cfg, device="cpu")(
        state, batch, priorities=_fpn_priorities(cfg, batch))
    monkeypatch.undo()
    assert state.step == 1 and len(own) == batch["image"].shape[0]
    return ({k: float(v) for k, v in metrics.items()},
            to_jax_params(model.state_dict()), own)


@pytest.mark.parametrize("family", FAMILIES)
def test_fpn_train_step_matches_jax_and_golden(jax_step, family, monkeypatch):
    """One step of the port on synth_params and _fixed_batch with the
    JAX-drawn priorities.

    (i) With the JAX step's proposals, against the JAX step run here: every
    metric at 1e-4 relative; every updated leaf within 1e-6 + 1e-3 of its
    update (the pair_pos_fc1 leaves 5e-6, as in tests/test_torch_train.py);
    frozen leaves bit-equal.
    (ii) With its own proposals: those within 1e-3 px of the JAX step's, and
    against tests/golden/train_<family>.npz, metrics and update_norm at 1e-3
    relative, update_count equal."""
    from relation_tpu.core.trainer import trainable_mask as j_mask
    from flax.traverse_util import flatten_dict
    cfg, params, before, j_after, j_metrics = jax_step(family)
    j_rois = _jax_proposals(cfg, params, _fixed_batch())
    metrics, after, _ = _port_step(cfg, params, monkeypatch, proposals=j_rois)
    assert set(metrics) == set(j_metrics)
    for k, want in j_metrics.items():
        assert np.isfinite(metrics[k])
        assert metrics[k] == pytest.approx(want, rel=1e-4, abs=1e-7), k
    trainable = {"/".join(k): v for k, v in flatten_dict(
        j_mask(params, tuple(cfg.network.FIXED_PARAMS))).items()}
    assert set(after) == set(before) == set(trainable)
    for k in before:
        if not trainable[k]:
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)
            np.testing.assert_array_equal(j_after[k], before[k], err_msg=k)
            continue
        want = j_after[k] - before[k]
        atol = 5e-6 if "pair_pos_fc1" in k else 1e-6
        np.testing.assert_allclose(after[k] - before[k], want, rtol=1e-3,
                                   atol=atol, err_msg=k)
        assert np.abs(want).max() > 0, k

    metrics, after, own = _port_step(cfg, params, monkeypatch)
    for got, want in zip(own, j_rois):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    with np.load(f"{GOLDEN_DIR}/train_{family}.npz") as z:
        golden = {k: float(z[k]) for k in z.files}
    norm, moved = _update_stats(before, after)
    assert moved == golden.pop("update_count")
    assert norm == pytest.approx(golden.pop("update_norm"), rel=1e-3)
    assert set(golden) == set(metrics)
    for k, want in golden.items():
        assert metrics[k] == pytest.approx(want, rel=1e-3, abs=1e-6), k


def test_pool_pyramid_gradient_matches_jax():
    """pool_pyramid (ROIs grouped by level, pooled at their level, put back
    in their order) against the JAX head's pooling (every ROI pooled at the
    four levels, its own selected): the pooled values at 1e-5 of their
    largest, and the gradient of a random cotangent with respect to each
    level of the pyramid at 1e-5 of its largest. ROIs of all four dispatch
    levels, and two of one level next to each other."""
    from relation_tpu.models.fpn import DISPATCH_STRIDES as J_STRIDES
    from relation_tpu.models.fpn import roi_level_dispatch as j_dispatch
    from relation_tpu.ops.roi_pool import roi_align_mxu as j_align
    from relation_tpu_torch.models.fpn import (DISPATCH_STRIDES, pool_pyramid,
                                               roi_level_dispatch)
    rng = np.random.RandomState(0)
    size = 512
    pyr = {s: rng.randn(size // s, size // s, 8).astype(np.float32)
           for s in DISPATCH_STRIDES}
    wh = np.array([[30, 40], [300, 280], [230, 200], [60, 80], [10, 14],
                   [600, 520], [120, 150], [20, 20]], np.float32)
    xy = rng.uniform(0, 60, (len(wh), 2)).astype(np.float32)
    rois = np.concatenate([xy, xy + wh - 1], 1)
    assert set(n(roi_level_dispatch(t(rois))).tolist()) == {0, 1, 2, 3}
    cot = rng.randn(len(rois), 7, 7, 8).astype(np.float32)

    def j_pool(levels):
        parts = jnp.stack([j_align(levels[s], J(rois), 1.0 / s, 7)
                           for s in J_STRIDES])             # [4, R, 7, 7, C]
        sel = jax.nn.one_hot(j_dispatch(J(rois)), 4, dtype=jnp.float32)
        return jnp.einsum("lrhwc,rl->rhwc", parts, sel)
    want, vjp = jax.vjp(j_pool, {s: J(v) for s, v in pyr.items()})
    (j_grad,) = vjp(J(cot))
    levels = {s: t(v).requires_grad_(True) for s, v in pyr.items()}
    got = pool_pyramid(levels, t(rois))
    grads = torch.autograd.grad(got, list(levels.values()), t(cot))
    top = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=0, atol=1e-5 * top)
    for s, g in zip(levels, grads):
        want_g = np.asarray(j_grad[s])
        assert np.abs(want_g).max() > 0, s
        np.testing.assert_allclose(n(g), want_g, rtol=0,
                                   atol=1e-5 * np.abs(want_g).max(), err_msg=str(s))
