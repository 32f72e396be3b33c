"""Port parity of the DCN train step: relation_tpu (JAX, CPU) against
relation_tpu_torch (PyTorch, CPU) on the same numpy inputs from a seed.

- the optimizer on DCN parameter names: x0.01 learning rate on the ``offset``
  FC only, weight decay and the freeze mask on the bare deformable weight,
  against the optax chain of the JAX trainer;
- one whole train step of the three DCN families on the tiny model of
  tests/test_golden_train.py (deformable PSROI head with its offset FC; the
  tiny trunk has no res5), against the JAX step run here and the committed
  train goldens, in the bands of tests/test_torch_train.py;
- one step of a model with a real deformable res5 at narrow width, so that
  the col2im (its plain version) sits inside a step: the hand-written
  backward against autograd of the same forward;
- the deformable conv's three gradients in bf16 compute with f32 offsets
  (the res5 train step's dtypes) against JAX's custom VJP in bf16.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tests.test_torch_helpers import n, t
from tests.test_golden_e2e import GOLDEN_DIR, family_cfg
from tests.test_golden_train import _fixed_batch
from tests.test_torch_train import (_port_step, _update_stats,  # noqa: F401
                                    jax_step)
from relation_tpu_torch.convert import from_jax_params, init_params, to_jax_params

J = jnp.asarray


class _DCNNames(torch.nn.Module):
    """The DCN leaves of the detector under their real names, narrow."""

    def __init__(self):
        super().__init__()
        from relation_tpu_torch.models.backbone import ResNet101C5DCN
        from relation_tpu_torch.models.relation import Dense
        self.c5 = ResNet101C5DCN(cin=4, mid=4, out=4)
        self.offset = Dense(6, 98)
        self.fc_new_1 = Dense(6, 5)


@pytest.mark.parametrize("clip", [0.0, 0.05])
def test_optimizer_on_dcn_names_matches_optax(clip):
    """Two updates of every DCN leaf against the JAX trainer's optax chain
    (clip, weight decay on trainable leaves, SGD + momentum, x0.01 where the
    path has the ELEMENT ``offset``, nothing on frozen leaves), to 1e-6 on
    parameters of size 0.1 (the clip's global norm is an f32 sum taken in
    another order): the
    ``offset`` FC moves 100 times slower than ``fc_new_1``, the offset convs
    (``res5x_branch2b_offset``) and the bare ``res5x_branch2b_weight`` move
    at the full rate with weight decay, and the 5a branch frozen by prefix
    stays put."""
    import optax
    from flax.traverse_util import flatten_dict, unflatten_dict
    from relation_tpu.core.trainer import (make_optimizer as j_make,
                                           trainable_mask as j_mask)
    from relation_tpu_torch.core.trainer import make_optimizer, trainable_mask
    cfg = family_cfg("dcn")
    cfg.TPU.GRAD_CLIP = clip
    fixed = ["res5a_branch2a", "bn5", "gamma", "beta"]
    model = init_params(_DCNNames(), seed=3)
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(t(rng.randn(*p.shape).astype(np.float32) * 0.1))
    mask = trainable_mask(model, fixed)
    assert not mask["c5.DCNBottleneck_0.res5a_branch2a.weight"]
    assert mask["c5.DCNBottleneck_0.res5a_branch2b_weight"]
    assert mask["c5.DCNBottleneck_1.res5b_branch2b_offset.bias"]
    assert not mask["c5.DCNBottleneck_1.bn5b_branch2b.moving_var"]

    def tree(flat):
        return unflatten_dict({tuple(k.split("/")): J(v) for k, v in flat.items()})
    params = tree(to_jax_params(model.state_dict()))
    j_m = j_mask(params, fixed)
    assert {"/".join(k): v for k, v in flatten_dict(j_m).items()} == {
        k: mask[tk_] for k, tk_ in zip(to_jax_params(model.state_dict()),
                                       model.state_dict())}
    jtx = j_make(cfg, 1000, j_m)
    jstate = jtx.init(params)
    tx = make_optimizer(cfg, 1000, mask)
    trace = tx.init(model)
    before = to_jax_params(model.state_dict())
    for step in range(2):
        grads = {k: rng.randn(*v.shape).astype(np.float32)
                 for k, v in model.state_dict().items()}
        for name, p in model.named_parameters():
            p.grad = t(grads[name])
        tx.update(model, trace, step)
        updates, jstate = jtx.update(tree(to_jax_params(
            {k: t(v) for k, v in grads.items()})), jstate, params)
        params = optax.apply_updates(params, updates)
    after = to_jax_params(model.state_dict())
    want = {"/".join(k): np.asarray(v) for k, v in flatten_dict(params).items()}
    for k in want:
        np.testing.assert_allclose(after[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    moved = {k: np.abs(after[k] - before[k]).max() for k in after}
    assert moved["c5/DCNBottleneck_0/res5a_branch2a/kernel"] == 0
    assert moved["offset/kernel"] > 0 and moved["offset/bias"] > 0
    assert moved["offset/kernel"] < 0.03 * moved["fc_new_1/kernel"]
    for k in ("c5/DCNBottleneck_0/res5a_branch2b_offset/kernel",
              "c5/DCNBottleneck_0/res5a_branch2b_offset/bias",
              "c5/DCNBottleneck_0/res5a_branch2b_weight"):
        assert moved[k] > 0.3 * moved["fc_new_1/kernel"], k


def test_convert_handles_the_dcn_leaves():
    """from_jax_params / to_jax_params on the bare rank-4 HWIO weight, the
    offset conv's kernel and bias and the offset Dense: layouts checked
    element by element, the round trip exact, init_params zero on the
    offset branches and variance-scaled on the bare weight."""
    model = _DCNNames()
    rng = np.random.RandomState(1)
    flat = {k: rng.randn(*v.shape).astype(np.float32)
            for k, v in to_jax_params(init_params(model, seed=0).state_dict()).items()}
    w = flat["c5/DCNBottleneck_2/res5c_branch2b_weight"]
    k = flat["c5/DCNBottleneck_2/res5c_branch2b_offset/kernel"]
    assert w.shape == (3, 3, 4, 4) and k.shape == (3, 3, 4, 72)
    assert flat["offset/kernel"].shape == (6, 98)
    sd = from_jax_params(flat, model)
    tw = sd["c5.DCNBottleneck_2.res5c_branch2b_weight"]
    assert float(tw[3, 1, 2, 0]) == w[2, 0, 1, 3]               # OIHW <- HWIO
    assert float(sd["c5.DCNBottleneck_2.res5c_branch2b_offset.weight"][70, 1, 0, 2]) \
        == k[0, 2, 1, 70]
    np.testing.assert_array_equal(
        n(sd["c5.DCNBottleneck_2.res5c_branch2b_offset.bias"]),
        flat["c5/DCNBottleneck_2/res5c_branch2b_offset/bias"])
    assert float(sd["offset.weight"][97, 5]) == flat["offset/kernel"][5, 97]
    model.load_state_dict(sd)
    back = to_jax_params(model.state_dict())
    assert set(back) == set(flat)
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key], err_msg=key)
    fresh = init_params(_DCNNames(), seed=0).state_dict()
    for key, v in fresh.items():
        if "_offset." in key or key.startswith("offset."):
            assert not v.any(), key
    bare = fresh["c5.DCNBottleneck_0.res5a_branch2b_weight"]
    assert 0.2 < float(bare.std()) / (2.0 / 36) ** 0.5 < 2.0


@pytest.mark.parametrize("family", ["dcn", "dcn_relation", "dcn_learn_nms"])
def test_dcn_train_step_matches_jax_and_golden(jax_step, family):
    """One step of the port on synth_params and _fixed_batch with the
    JAX-drawn priorities, in the bands of tests/test_torch_train.py.

    (i) Against the JAX step run here (exact-trig bias): every metric at
    1e-4 relative; every updated leaf within 1e-6 + 1e-3 of its update
    (5e-6 on the pair_pos_fc1 leaves, whose gradient holds g/acc of pairs
    close to the clamp); frozen leaves bit-equal. The ``offset`` FC is among
    the updated leaves: its gradient runs through both deformable pools.
    (ii) Against tests/golden/train_<family>.npz (Pallas kernels in
    interpret mode): metrics and update_norm at 1e-3 relative, update_count
    equal."""
    from relation_tpu.core.trainer import trainable_mask as j_mask
    from flax.traverse_util import flatten_dict
    cfg, params, before, j_after, j_metrics = jax_step(family)
    metrics, after, _ = _port_step(cfg, params)
    assert set(metrics) == set(j_metrics)
    for k, want in j_metrics.items():
        assert np.isfinite(metrics[k])
        assert metrics[k] == pytest.approx(want, rel=1e-4, abs=1e-7), k
    trainable = {"/".join(k): v for k, v in flatten_dict(
        j_mask(params, tuple(cfg.network.FIXED_PARAMS))).items()}
    assert set(after) == set(before) == set(trainable)
    assert trainable["offset/kernel"] and trainable["offset/bias"]
    for k in before:
        if not trainable[k]:
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)
            continue
        want = j_after[k] - before[k]
        atol = 5e-6 if "pair_pos_fc1" in k else 1e-6
        np.testing.assert_allclose(after[k] - before[k], want, rtol=1e-3,
                                   atol=atol, err_msg=k)
        assert np.abs(want).max() > 0, k
    with np.load(f"{GOLDEN_DIR}/train_{family}.npz") as z:
        golden = {k: float(z[k]) for k in z.files}
    norm, moved = _update_stats(before, after)
    assert moved == golden.pop("update_count")
    assert norm == pytest.approx(golden.pop("update_norm"), rel=1e-3)
    assert set(golden) == set(metrics)
    for k, want in golden.items():
        assert metrics[k] == pytest.approx(want, rel=1e-3, abs=1e-6), k


def test_step_with_a_real_deformable_res5(monkeypatch):
    """The tiny dcn_learn_nms model with a narrow ResNet101C5DCN (32 -> mid
    16 -> 32 channels, 4 deformable groups) in place of its missing res5,
    offsets seeded away from zero: one train step launches the col2im three
    times (its plain version here), every offset leaf and bare weight moves,
    and every updated leaf agrees with the same step taken with autograd of
    the gathers in place of the hand-written backward, to 1e-5 of the
    leaf's largest update plus one f32 step of the parameter itself (an
    update of 5e-7 on a weight of 0.04 is only known to the weight's last
    bit)."""
    import relation_tpu_torch.models.backbone as bb
    import relation_tpu_torch.ops.deform as td
    from relation_tpu_torch.core.trainer import (build_model, create_train_state,
                                                 make_train_step)
    cfg = family_cfg("dcn_learn_nms")
    batch = _fixed_batch()
    calls = []
    plain = td.dconv_col2im

    def counted(*a):
        calls.append(a[3].shape)
        return plain(*a)
    monkeypatch.setattr(td, "dconv_col2im", counted)

    def auto_conv(x, offset, weights, kernel=3, stride=1, dilation=1, pad=None,
                  num_groups=4):
        pad = ((kernel - 1) // 2) * dilation if pad is None else pad
        yy, xx = td._tap_coords(offset, kernel, stride, dilation, pad, num_groups)
        col = td._col(x, yy, xx, num_groups)
        rows = col.shape[0] * col.shape[1] * col.shape[2]
        return (col.reshape(rows, -1) @ weights.reshape(-1, weights.shape[-1])
                ).view(*col.shape[:3], -1)

    def run(autograd_conv):
        model = build_model(cfg, tiny=True, device="cpu")
        model.c5 = bb.ResNet101C5DCN(cin=32, mid=16, out=32)
        init_params(model, seed=4)
        rng = np.random.RandomState(8)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if "_offset." in name or name.startswith("offset."):
                    p.copy_(t(rng.randn(*p.shape).astype(np.float32) * 0.04))
        start = {k: v.clone() for k, v in model.state_dict().items()}
        if autograd_conv:
            monkeypatch.setattr(bb, "deformable_conv_batched", auto_conv)
        state = create_train_state(model, cfg, seed=1)
        rs = np.random.RandomState(2)
        K = 4 * 4 * int(cfg.network.NUM_ANCHORS)
        prio = [{"anchor": tuple(rs.uniform(0, 1, (2, K)).astype(np.float32))}
                for _ in range(2)]
        _, m = make_train_step(model, cfg, device="cpu")(state, batch, priorities=prio)
        return start, model.state_dict(), {k: float(v) for k, v in m.items()}
    start, hand, m_hand = run(False)
    assert calls == [torch.Size([2, 16 * 9, 4, 4])] * 3
    _, auto, m_auto = run(True)
    assert len(calls) == 3
    assert m_hand == m_auto and all(np.isfinite(v) for v in m_hand.values())
    for k in start:
        upd = (auto[k] - start[k]).abs().max()
        ulp = 1.2e-7 * float(start[k].abs().max())
        np.testing.assert_allclose(n(hand[k] - start[k]), n(auto[k] - start[k]),
                                   rtol=0, atol=1e-5 * float(upd) + ulp, err_msg=k)
        if "branch2b_offset" in k or "branch2b_weight" in k or k.startswith("offset."):
            assert float(upd) > 0, k


def test_deformable_conv_bf16_gradients_follow_jax():
    """x and the weight in bf16, offsets in f32, as res5 trains: the port's
    hand-written backward against JAX's _dconv_bwd_b, offset gradient first.
    B=1, an 8x12 map, 4 offset groups, 16 channels, 3x3, dilation 2 (res5's).
    The two agree within bf16 rounding (measured 3.6e-3 to 5.9e-3 of the
    largest element, correlation >= 0.99998; JAX's own bf16 against its f32
    is 5.8e-3 to 7.1e-3 apart), and bf16 does not grow the offset gradient:
    its norm is the f32 gradient's within 1%. Band: 1e-2 of the largest
    element, correlation 0.9999, norms within 1%."""
    import relation_tpu.ops.deform as jd
    import relation_tpu_torch.ops.deform as td
    import jax
    rng = np.random.RandomState(0)
    B, H, W, C, Co, G = 1, 8, 12, 16, 16, 4
    x = rng.randn(B, H, W, C).astype(np.float32)
    w = (rng.randn(3, 3, C, Co) * 0.1).astype(np.float32)
    off = rng.uniform(-3, 3, (B, H, W, G * 2 * 9)).astype(np.float32)
    # 1e-3 clear of integers, where the offset gradient jumps
    off = np.where(np.abs(off - np.round(off)) < 1e-3, off + 2e-3, off)
    off = off.astype(np.float32)
    dout = rng.randn(B, H, W, Co).astype(np.float32)
    kw = dict(kernel=3, dilation=2, num_groups=G)

    def jax_grads(dt):
        def loss(x_, o_, w_):
            y = jd.deformable_conv_batched(x_.astype(dt), o_, w_.astype(dt), **kw)
            return jnp.sum(y.astype(jnp.float32) * dout)
        return [np.asarray(g, np.float32) for g in
                jax.grad(loss, argnums=(0, 1, 2))(J(x), J(off), J(w))]

    def port_grads(dt):
        ins = [t(a).requires_grad_(True) for a in (x, off, w)]
        y = td.deformable_conv_batched(ins[0].to(dt), ins[1], ins[2].to(dt), **kw)
        loss = (y.float() * t(dout)).sum()
        return [n(g.float()) for g in torch.autograd.grad(loss, ins)]

    want, got = jax_grads(jnp.bfloat16), port_grads(torch.bfloat16)
    got32 = port_grads(torch.float32)
    for name, g, r, g32 in zip(("doffset", "dx", "dw"), (got[1], got[0], got[2]),
                               (want[1], want[0], want[2]),
                               (got32[1], got32[0], got32[2])):
        assert np.abs(g - r).max() <= 1e-2 * np.abs(r).max(), name
        assert np.corrcoef(g.ravel(), r.ravel())[0, 1] >= 0.9999, name
        assert abs(np.linalg.norm(g) / np.linalg.norm(r) - 1) <= 1e-2, name
        assert abs(np.linalg.norm(g) / np.linalg.norm(g32) - 1) <= 1e-2, name
