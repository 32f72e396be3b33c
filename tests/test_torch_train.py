"""Port parity of the training path: relation_tpu (JAX, CPU) against
relation_tpu_torch (PyTorch, CPU) on the same numpy inputs from a seed.

- the geometric-bias backward: the port's public function under autograd,
  its step-by-step plain version, jax.vjp of the jnp reference and the Pallas
  backward kernel in interpret mode;
- the fully fused learned-NMS attention, forward and gradients;
- every function of models/targets.py and models/losses.py, the random
  subsampling fed with priorities drawn by JAX along the key path of the JAX
  train step;
- the schedule, the freeze masks, the f32 master weights, the
  no-gradient boundary of the trunk;
- one whole train step of the four C4 families on the tiny model of
  tests/test_golden_train.py, against the JAX step run here and against the
  committed train goldens.

Where a JAX function reaches the Pallas geometric bias, the tight bands use
its jnp reference (exact sin/cos, the formula the port implements): the
Pallas polynomial sin/cos is off by up to ~2e-3 in the bias
(tests/test_torch_kernels_plain.py) and is held in its own, wider band.
"""

import contextlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tests.test_torch_helpers import flat_numpy, n, port_model, t
from tests.test_golden_e2e import GOLDEN_DIR, family_cfg, synth_params
from tests.test_golden_train import _fixed_batch
import relation_tpu.models.losses as jl
import relation_tpu.models.targets as jt
import relation_tpu.ops.pallas.geom_bias as jgb
import relation_tpu.ops.pallas.nms_attention as jna
import relation_tpu_torch.models.losses as tl
import relation_tpu_torch.models.targets as tt
from relation_tpu_torch.ops.kernels import geom_bias as tg, nms_attention as ta

J = jnp.asarray


# --------------------------------------------------------------------------
# (a) geometric-bias backward
# --------------------------------------------------------------------------

def _geom_case(seed, shape, b_shift=0.0):
    rng = np.random.RandomState(seed)
    C, _, N, M = shape
    G = 16
    pos = (rng.randn(C, 4, N, M) * 1.5).astype(np.float32)
    w = (rng.randn(64, G) * 0.1).astype(np.float32)
    b = (rng.randn(G) * 0.05 + b_shift).astype(np.float32)
    gout = rng.randn(C, G, N, M).astype(np.float32)
    return pos, w, b, gout


def _port_autograd(pos, w, b, gout):
    """(d_pos, d_W, d_b) of the port's public function on CPU tensors."""
    ins = [t(x).requires_grad_(True) for x in (pos, w, b)]
    out = tg.fused_geometric_bias(*ins)
    return [n(g) for g in torch.autograd.grad(out, ins, t(gout))]


@pytest.mark.parametrize("shape", [(2, 4, 5, 7), (1, 4, 19, 16), (3, 4, 16, 16)])
def test_geom_bias_backward_matches_jax(shape):
    """Against jax.vjp of the jnp reference at 1e-4 of each gradient's
    maximum, with the cotangent zero within 2e-2 of the clamp: there 1/acc
    (up to 1e6 at the clamp) amplifies the last-bit difference between two
    f32 sums of acc beyond any band. Against the Pallas backward kernel
    (interpret mode), whose polynomial sin/cos moves acc by up to ~2e-3:
    cotangent zero within 0.1 of the clamp, 3e-2 of the maximum."""
    pos, w, b, gout = _geom_case(sum(shape), shape)
    acc = n(tg.geom_acc_reference(t(pos), t(w), t(b)))
    for margin, pallas_tol in ((2e-2, None), (0.1, 3e-2)):
        g = gout * ((acc > margin) | (acc < -margin))
        _, vjp = jax.vjp(lambda p, k, bb: jgb.geom_bias_reference(p, k, bb),
                         J(pos), J(w), J(b))
        want = [np.asarray(x) for x in vjp(J(g))]
        plain = [n(x) for x in tg.geom_bias_bwd_reference(t(pos), t(w), t(b), t(g))]
        auto = _port_autograd(pos, w, b, g)
        for name, a, p, r in zip(("d_pos", "d_W", "d_b"), auto, plain, want):
            top = np.abs(r).max()
            assert top > 0, name
            assert a.shape == p.shape == r.shape
            np.testing.assert_allclose(p, r, rtol=0, atol=1e-4 * top, err_msg=name)
            np.testing.assert_allclose(a, r, rtol=0, atol=1e-4 * top, err_msg=name)
        if pallas_tol is not None:
            pk = jgb._geom_bias_bwd_impl(J(pos), J(w), J(b), J(g), 100.0, True)
            for name, p, k in zip(("d_pos", "d_W", "d_b"), plain, pk):
                np.testing.assert_allclose(
                    p, np.asarray(k), rtol=0,
                    atol=pallas_tol * np.abs(p).max(), err_msg=name)


def test_geom_bias_backward_clamped_heads_get_exactly_zero():
    """Heads whose b is negative enough are clamped on every pair: their
    columns of d_W and entries of d_b are exactly zero, in the port's
    autograd path, its plain backward, the jnp VJP and the Pallas kernel;
    the other heads (b = +1, clear of the clamp) agree at 1e-4."""
    pos, w, b, gout = _geom_case(5, (2, 4, 6, 9))
    w *= 0.2
    b[:] = 1.0
    b[::2] = -10.0
    acc = n(tg.geom_acc_reference(t(pos), t(w), t(b)))
    assert (acc[:, ::2] < 0).all() and (acc[:, 1::2] > 0.3).all()
    _, vjp = jax.vjp(lambda p, k, bb: jgb.geom_bias_reference(p, k, bb),
                     J(pos), J(w), J(b))
    want = [np.asarray(x) for x in vjp(J(gout))]
    plain = [n(x) for x in tg.geom_bias_bwd_reference(t(pos), t(w), t(b), t(gout))]
    auto = _port_autograd(pos, w, b, gout)
    pallas = [np.asarray(x) for x in jgb._geom_bias_bwd_impl(
        J(pos), J(w), J(b), J(gout), 100.0, True)]
    for got in (want, plain, auto, pallas):
        assert not got[1][:, ::2].any() and not got[2][::2].any()
        assert got[1][:, 1::2].any() and got[2][1::2].all()
    for a, p, r in zip(auto, plain, want):
        np.testing.assert_allclose(p, r, rtol=0, atol=1e-4 * np.abs(r).max())
        np.testing.assert_allclose(a, r, rtol=0, atol=1e-4 * np.abs(r).max())


def test_geom_bias_function_glue_on_plain_launchers(monkeypatch):
    """The autograd.Function that the card runs, with its two launchers
    replaced by the plain versions: it saves only the inputs, takes a
    non-contiguous cotangent and a transposed (non-contiguous) W, skips
    d_pos when pos needs no gradient, and counts one launch each way."""
    pos, w, b, gout = _geom_case(11, (2, 4, 5, 7))
    calls = []

    def launch(p, k, bb, scale, raw=False):
        assert p.is_contiguous() and k.is_contiguous()
        return tg.geom_bias_reference(p, k, bb, scale)

    def launch_bwd(p, k, bb, g, scale, need_pos=True, want_acc=False):
        assert g.is_contiguous() and k.is_contiguous()
        calls.append(need_pos)
        d_pos, d_w, d_b = tg.geom_bias_bwd_reference(p, k, bb, g, scale)
        return (d_pos if need_pos else None, d_w, d_b)
    monkeypatch.setattr(tg, "_launch", launch)
    monkeypatch.setattr(tg, "_launch_bwd", launch_bwd)
    before = (tg.launches, tg.bwd_launches)
    wt = t(np.ascontiguousarray(w.T)).requires_grad_(True)      # [G, 64] leaf
    bb = t(b).requires_grad_(True)
    out = tg._GeomBias.apply(t(pos), wt.t(), bb, 100.0)
    cot = t(np.ascontiguousarray(gout.transpose(0, 2, 1, 3)))   # [C, N, G, M]
    (out.permute(0, 2, 1, 3) * cot).sum().backward()
    assert calls == [False]
    assert (tg.launches, tg.bwd_launches) == (before[0] + 1, before[1] + 1)
    _, d_w, d_b = tg.geom_bias_bwd_reference(t(pos), t(w), t(b), t(gout))
    np.testing.assert_array_equal(n(wt.grad), n(d_w).T)
    np.testing.assert_array_equal(n(bb.grad), n(d_b))
    p = t(pos).requires_grad_(True)
    tg._GeomBias.apply(p, t(w), t(b), 100.0).backward(t(gout))
    assert calls == [False, True] and p.grad.shape == p.shape


# --------------------------------------------------------------------------
# (b) fully fused learned-NMS attention
# --------------------------------------------------------------------------

def _attention_case(seed, C=3, N=8, G=16, D=64, F=128, E=8):
    rng = np.random.RandomState(seed)
    return [a.astype(np.float32) for a in (
        rng.randn(C, 4, N, N), rng.randn(C, N, G * D) * 0.2,
        rng.randn(C, N, G * D) * 0.2, rng.randn(C, N, F),
        rng.randn(64, G) * 0.1, rng.randn(G) * 0.05 + 1.0,
        rng.randn(G, F, E) * 0.1)]


def test_fused_attention_forward_and_gradients_match_jax(monkeypatch):
    """The JAX custom-VJP function (forward: Pallas kernel in interpret mode,
    backward: jax.vjp of the jnp reference) against the port on the CPU.
    Forward at 1e-4 against the jnp reference and 1e-2 against the Pallas
    kernel; the seven gradients at 1e-4 of their maxima (b = 1 + noise keeps
    acc clear of the clamp). Then the card's autograd.Function with its
    launcher replaced by the plain version: same gradients, one launch."""
    args = _attention_case(2)
    ct = np.random.RandomState(9).randn(3, 8, 16 * 8).astype(np.float32)
    jout, vjp = jax.vjp(jna.fused_nms_relation_attention, *map(J, args))
    jgrads = [np.asarray(g) for g in vjp(J(ct))]
    jref = np.asarray(jna.nms_relation_attention_reference(*map(J, args)))

    def port(fn):
        ins = [t(a).requires_grad_(True) for a in args]
        out = fn(*ins)
        return n(out), [n(g) for g in torch.autograd.grad(out, ins, t(ct))]
    out, grads = port(ta.fused_nms_relation_attention)
    np.testing.assert_allclose(out, jref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(out, np.asarray(jout), rtol=1e-2, atol=1e-2)
    for g, want in zip(grads, jgrads):
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-4 * np.abs(want).max())

    def launch(pos, q, k, v, wg, bg, wl, active, scale, name):
        assert active is None
        return ta.nms_relation_attention_reference(pos, q, k, v, wg, bg, wl,
                                                   None, scale)
    monkeypatch.setattr(ta, "_launch", launch)
    before = ta.full_launches
    out2, grads2 = port(lambda *a: ta._FullAttention.apply(*a, 100.0))
    assert ta.full_launches == before + 1
    np.testing.assert_array_equal(out2, out)
    for g, want in zip(grads2, grads):
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_kernels_without_backward_refuse_a_gradient():
    """The rule the CUDA wrappers apply before a launch: an input that asks
    for a gradient is refused while gradients are recorded, and accepted
    under no_grad (tests/test_torch_cuda.py holds the wrappers to it on the
    card). On the CPU the plain versions carry real gradients."""
    from relation_tpu_torch.ops.kernels import _build, stem as ts
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        _build.refuse_grad("k", torch.zeros(3), x)
    with torch.no_grad():
        _build.refuse_grad("k", x)
    _build.refuse_grad("k", x.detach())
    rng = np.random.RandomState(0)
    w4 = t(rng.randn(192, 64).astype(np.float32) * 0.05).requires_grad_(True)
    out = ts.stem_conv1_bn_relu(t(rng.randn(1, 12, 4, 6).astype(np.float32)), w4,
                                torch.ones(64), torch.zeros(64))
    out.float().sum().backward()
    assert w4.grad is not None and float(w4.grad.abs().sum()) > 0


# --------------------------------------------------------------------------
# (c) targets and losses
# --------------------------------------------------------------------------

def _boxes(rng, k, size=64.0):
    xy = rng.uniform(0, size * 0.6, (k, 2))
    wh = rng.uniform(6, size * 0.45, (k, 2))
    return np.concatenate([xy, np.minimum(xy + wh, size - 1)], 1).astype(np.float32)


def _gt(rng, g=4, valid=3, classes=4):
    gt = np.zeros((g, 5), np.float32)
    gt[:valid, :4] = _boxes(rng, valid)
    gt[:valid, 4] = rng.randint(1, classes + 1, valid)
    gv = np.zeros(g, bool)
    gv[:valid] = True
    return gt, gv


def _eq(got, want, exact=False):
    got = [n(x) for x in got]
    want = [np.asarray(x) for x in want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if exact or w.dtype.kind in "ib":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cap,k_max", [(3, 3), (2, 5), (0, 4), (7, 7)])
def test_keep_top_keeps_the_earlier_index_among_ties(cap, k_max):
    prio = np.array([.5, .9, .5, .5, .1, .9, .5, .3, .9, .5], np.float32)
    mask = np.array([1, 1, 1, 0, 1, 1, 1, 1, 0, 1], bool)
    want = np.asarray(jt._keep_top(J(mask), J(prio), cap, k_max))
    got = n(tt._keep_top(t(mask), t(prio), cap, k_max))
    np.testing.assert_array_equal(got, want)
    assert got.sum() == min(cap, k_max, mask.sum())
    # a traced (tensor) cap selects the same set
    np.testing.assert_array_equal(
        n(tt._keep_top(t(mask), t(prio), torch.tensor(cap), k_max)), want)


@pytest.mark.parametrize("seed,valid,clobber", [(0, 3, False), (1, 0, False),
                                                (2, 2, True)])
def test_anchor_targets_match_jax(seed, valid, clobber):
    """Shared priorities: drawn by JAX from the key the JAX function splits
    (targets.py:94), handed to the port. A small batch (8, fg fraction 0.5)
    makes both subsamplings bite; valid=0 is the no-gt image."""
    from relation_tpu.ops.anchors import generate_anchors, shift_anchors
    from relation_tpu_torch.ops.anchors import shift_anchors as t_shift
    rng = np.random.RandomState(seed)
    base = generate_anchors(16, (0.5, 1, 2), (1, 2))
    anchors = np.asarray(shift_anchors(base, 4, 4, 16))
    np.testing.assert_array_equal(n(t_shift(base, 4, 4, 16)), anchors)
    gt, gv = _gt(rng, valid=valid)
    im_info = np.array([64.0, 64.0, 1.0], np.float32)
    key = jax.random.PRNGKey(seed)
    kw = dict(rpn_batch_size=8, fg_fraction=0.5, positive_overlap=0.5,
              negative_overlap=0.3, clobber_positives=clobber,
              bbox_weights=(1.0, 2.0, 1.0, 0.5))
    want = jt.anchor_targets(J(anchors), J(gt), J(gv), J(im_info), key, **kw)
    k_fg, k_bg = jax.random.split(key)
    K = anchors.shape[0]
    prio = (np.asarray(jax.random.uniform(k_fg, (K,))),
            np.asarray(jax.random.uniform(k_bg, (K,))))
    got = tt.anchor_targets(t(anchors), t(gt), t(gv), t(im_info),
                            priorities=prio, **kw)
    _eq(got, want)
    label = n(got[0])
    assert (label >= 0).sum() <= 8
    if valid:
        assert (label == 1).any() and (label == 0).any()
    # drawn from a generator: same label counts, a seeded draw repeats
    gen = torch.Generator().manual_seed(3)
    a = tt.anchor_targets(t(anchors), t(gt), t(gv), t(im_info), gen, **kw)
    gen.manual_seed(3)
    b = tt.anchor_targets(t(anchors), t(gt), t(gv), t(im_info), gen, **kw)
    assert torch.equal(a[0], b[0])
    assert int((a[0] == 1).sum()) == int((label == 1).sum())


@pytest.mark.parametrize("batch_rois,pad_mode", [(-1, "repeat"), (12, "repeat"),
                                                 (12, "distinct"), (40, "repeat")])
def test_sample_rois_match_jax(batch_rois, pad_mode):
    """Take-all and sampled mode, both pad modes, and a minibatch larger than
    the roi set (40 > 20 + 4: the gap rows). Two padded (invalid) rois."""
    rng = np.random.RandomState(batch_rois + 7)
    rois = _boxes(rng, 20)
    roi_valid = np.ones(20, bool)
    roi_valid[-2:] = False
    gt, gv = _gt(rng)
    rois[:3] = gt[:3, :4] + rng.uniform(-2, 2, (3, 4)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    kw = dict(batch_rois=batch_rois, num_reg_classes=2, fg_fraction=0.25,
              bbox_normalize=True, bbox_means=(0., 0., 0., 0.),
              bbox_stds=(0.1, 0.1, 0.2, 0.2), pad_mode=pad_mode)
    want = jt.sample_rois(J(rois), J(roi_valid), J(gt), J(gv), key, **kw)
    prio = [np.asarray(jax.random.uniform(k, (24,)))
            for k in jax.random.split(key, 4)]
    got = tt.sample_rois(t(rois), t(roi_valid), t(gt), t(gv), priorities=prio,
                         **kw)
    assert set(got) == set(want)
    for k in want:
        _eq([got[k]], [want[k]])
    assert (n(got["label"]) > 0).any()
    # class-aware regression targets
    kw.update(num_reg_classes=5)
    want = jt.sample_rois(J(rois), J(roi_valid), J(gt), J(gv), key, **kw)
    got = tt.sample_rois(t(rois), t(roi_valid), t(gt), t(gv), priorities=prio,
                         **kw)
    _eq([got["bbox_target"], got["bbox_weight"]],
        [want["bbox_target"], want["bbox_weight"]])


def test_ohem_select_and_expand_targets_match_jax(rng):
    R, K = 30, 5
    cls = rng.randn(R, K).astype(np.float32)
    bp = rng.randn(R, 8).astype(np.float32)
    label = rng.randint(-1, K, R)
    label[5], label[9] = label[6], label[6]
    cls[5] = cls[9] = cls[6]                    # equal losses: a tie
    bp[5] = bp[9] = bp[6]
    tgt = np.zeros((R, 8), np.float32)
    wgt = np.zeros((R, 8), np.float32)
    tgt[:, 4:] = rng.randn(R, 4)
    wgt[label > 0, 4:] = 1.0
    tgt[5] = tgt[9] = tgt[6]
    wgt[5] = wgt[9] = wgt[6]
    want = jt.ohem_select(J(cls), J(bp), J(label), J(tgt), J(wgt), 8)
    got = tt.ohem_select(t(cls), t(bp), t(label), t(tgt), t(wgt), 8)
    _eq(got, want)
    assert (n(got[0]) >= 0).sum() == 8
    for nrc in (2, 5):
        _eq(tt.expand_bbox_targets(t(label), t(tgt[:, 4:]), nrc, (1., 2., 3., 4.)),
            jt.expand_bbox_targets(J(label), J(tgt[:, 4:]), nrc, (1., 2., 3., 4.)))


def test_nms_multi_target_matches_jax_with_two_gts_of_one_class():
    rng = np.random.RandomState(4)
    Fn, C = 12, 3
    gt = np.zeros((4, 5), np.float32)
    gt[0] = [5, 5, 30, 30, 2]
    gt[1] = [28, 26, 55, 58, 2]                 # two ground truths of class 2
    gt[2] = [10, 30, 40, 60, 1]
    gv = np.array([1, 1, 1, 0], bool)
    boxes = np.zeros((Fn, C, 4), np.float32)
    for c in range(C):
        src = gt[rng.randint(0, 3, Fn), :4]
        boxes[:, c] = src + rng.uniform(-4, 4, (Fn, 4))
    score = np.sort(rng.uniform(0, 1, (Fn, C)).astype(np.float32), 0)[::-1].copy()
    score[3] = score[2]                         # equal scores: a tie
    thr = (0.5, 0.7, 0.9)
    want = np.asarray(jt.nms_multi_target(J(boxes), J(gt), J(gv), J(score), thr))
    got = n(tt.nms_multi_target(t(boxes), t(gt), t(gv), t(score), thr))
    np.testing.assert_array_equal(got, want)
    assert want[:, 1, 0].sum() == 2             # one winner per gt of class 2
    assert not want[:, 2].any()                 # class 3 has no gt


def test_losses_match_jax(rng):
    R, K, Fn, C, T = 40, 6, 7, 3, 4
    logits = rng.randn(R, K).astype(np.float32) * 3
    labels = rng.randint(-1, K, R)
    x = (rng.randn(R, 4) * 1.5).astype(np.float32)
    y = rng.randn(R, 4).astype(np.float32)
    wt = (rng.uniform(0, 1, (R, 4)) > 0.5).astype(np.float32)
    for sigma in (1.0, 3.0):
        _eq([tl.smooth_l1(t(x), sigma)], [jl.smooth_l1(J(x), sigma)])
    _eq(tl.softmax_ce_valid(t(logits), t(labels)),
        jl.softmax_ce_valid(J(logits), J(labels)))
    none = np.full(R, -1)
    _eq(tl.softmax_ce_valid(t(logits), t(none)),
        jl.softmax_ce_valid(J(logits), J(none)))
    rl = np.clip(labels, -1, 1)
    _eq(tl.rpn_losses(t(logits[:, :2]), t(x), t(rl), t(y), t(wt), 16, 3.0),
        jl.rpn_losses(J(logits[:, :2]), J(x), J(rl), J(y), J(wt), 16, 3.0))
    _eq(tl.rcnn_losses(t(logits), t(x), t(labels), t(y), t(wt), 128.0),
        jl.rcnn_losses(J(logits), J(x), J(labels), J(y), J(wt), 128.0))
    score = rng.uniform(0, 1, (Fn, C, T)).astype(np.float32)
    score[0, 0] = [0.0, 1.0, 1.0, 0.5]          # saturated: the 1 - 1e-7 clamp
    target = (rng.uniform(0, 1, (Fn, C, T)) > 0.7).astype(np.float32)
    target[0, 0] = [1, 1, 0, 0]
    got = tl.learn_nms_losses(t(score), t(target), 2.0, 3.0)
    _eq(got, jl.learn_nms_losses(J(score), J(target), 2.0, 3.0))
    assert all(np.isfinite(n(g)) for g in got)
    _eq([tl.accuracy_ignore(t(logits), t(labels))],
        [jl.accuracy_ignore(J(logits), J(labels))])
    _eq(tl.nms_accuracy(t(score), t(target)), jl.nms_accuracy(J(score), J(target)))


# --------------------------------------------------------------------------
# (d), (e) schedule, masks, master weights, the trunk's no-gradient boundary
# --------------------------------------------------------------------------

@pytest.mark.parametrize("warmup", [False, True])
def test_lr_schedule_matches_jax_at_the_boundaries(warmup):
    from relation_tpu.utils.lr import warmup_multi_factor_schedule as js
    from relation_tpu_torch.utils.lr import warmup_multi_factor_schedule as ps
    args = (5e-4, [30, 10], 0.1, warmup, 5e-5, 4)
    a, b = js(*args), ps(*args)
    for count in (0, 3, 4, 5, 9, 10, 11, 29, 30, 31, 1000):
        assert b(count) == pytest.approx(float(a(count)), rel=1e-6), count
    assert ps(1e-3, [], 0.1)(7) == float(js(1e-3, [], 0.1)(7)) == 1e-3


@pytest.mark.parametrize("family", ["plain_learn_nms", "learn_nms_only"])
def test_trainable_mask_and_freeze_through_match_jax(family):
    """The flagship prefix set and the frozen-trunk set of learn_nms_only, on
    the full-width parameter tree (shapes only): every leaf gets the JAX
    package's verdict, through the key mapping of to_jax_params."""
    from relation_tpu.core.trainer import (_freeze_through as j_ft,
                                           build_model as j_build,
                                           trainable_mask as j_mask)
    from relation_tpu_torch.core.trainer import (_freeze_through, build_model,
                                                 trainable_mask)
    from relation_tpu_torch.entry import flagship_cfg
    from __graft_entry__ import _flagship_cfg
    jcfg, cfg = _flagship_cfg(), flagship_cfg()
    if family == "learn_nms_only":
        fixed = ["conv1", "bn_conv1", "res", "bn", "rpn", "conv_new_1",
                 "fc_new", "cls_score", "bbox_pred", "gamma", "beta"]
        jcfg.network.FIXED_PARAMS = cfg.network.FIXED_PARAMS = fixed
    fixed = tuple(cfg.network.FIXED_PARAMS)
    assert tuple(jcfg.network.FIXED_PARAMS) == fixed
    jm = j_build(jcfg)
    n0 = int(jcfg.TEST.FIRST_N) + 1
    shapes = jax.eval_shape(
        lambda k: jm.init(k, jnp.zeros((12, 304, 512)), jnp.zeros((n0, 4)),
                          jnp.zeros((3,)), n0), jax.random.PRNGKey(0))["params"]
    from flax.traverse_util import flatten_dict
    want = {"/".join(k): v for k, v in flatten_dict(j_mask(shapes, fixed)).items()}
    model = build_model(cfg, device="meta")
    got = trainable_mask(model, fixed)
    assert len(got) == len(want)
    for key, on in got.items():
        parts = key.split(".")
        if parts[-1] == "weight":
            parts[-1] = "kernel"
        assert want["/".join(parts)] == on, key
    assert any(got.values()) and not all(got.values())
    assert model.c4.freeze_through == _freeze_through(fixed) == j_ft(fixed) \
        == jm.freeze_through == (2 if family == "plain_learn_nms" else 4)
    for prefixes in ([], ["res2"], ["conv1", "res2", "res3"], ["conv1", "res"],
                     ["conv1", "res3"]):
        assert _freeze_through(prefixes) == j_ft(prefixes)


def test_conv_keeps_f32_master_weights():
    """A bf16-computing conv stores its weight in f32: an SGD-sized update
    (5e-4 * 1e-3, far below bf16 resolution at 0.05) moves the master, the
    gradient reaches it through the cast, and the cached bf16 copy of a
    frozen weight is refreshed when the weight changes."""
    from relation_tpu_torch.core.trainer import build_model
    from relation_tpu_torch.entry import flagship_cfg
    from relation_tpu_torch.models.backbone import Conv2d
    model = build_model(flagship_cfg(), device="meta")
    convs = [m for m in model.modules() if isinstance(m, Conv2d)]
    assert len(convs) > 100
    assert all(m.weight.dtype == torch.float32 for m in convs)
    assert all(m.compute_dtype == torch.bfloat16 for m in convs)
    assert all(p.dtype == torch.float32 for p in model.parameters())

    conv = Conv2d(4, 4, 1, bias=False)
    conv.compute_dtype = torch.bfloat16
    with torch.no_grad():
        conv.weight.fill_(0.05)
    x = torch.ones(1, 4, 2, 2)
    out = conv(x)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert conv.weight.grad.dtype == torch.float32
    before = conv.weight.detach().clone()
    with torch.no_grad():
        conv.weight.add_(conv.weight.grad, alpha=-5e-4 * 1e-3)
    assert not torch.equal(conv.weight, before)
    assert torch.equal(conv.weight.to(torch.bfloat16), before.to(torch.bfloat16))
    conv.weight.requires_grad_(False)
    first = conv(x)
    assert conv(x).data_ptr() != first.data_ptr()
    cached = conv._cast_cache["w"][1]
    assert conv._cast(conv.weight, torch.bfloat16, "w") is cached
    with torch.no_grad():
        conv.weight.fill_(1.0)
    assert float(conv(x).float().mean()) == 4.0


def test_trunk_sends_no_gradient_below_freeze_through():
    """freeze_through=2 on the full-depth trunk (f32, 32x32 image): conv1 and
    res2 get no gradient although they ask for one, res3 and res4 do, and
    the output equals the unfrozen trunk's."""
    from relation_tpu_torch.models.backbone import ResNet101C4
    torch.manual_seed(0)
    net = ResNet101C4(dtype=torch.float32, freeze_through=2)
    for p in net.parameters():
        torch.nn.init.normal_(p, std=0.05)
    x = torch.randn(1, 32, 32, 3)
    out = net(x)
    out.sum().backward()
    stage = {}
    for name, p in net.named_parameters():
        key = "stem" if name.startswith("conv1") else name.split(".")[1][:4]
        stage.setdefault(key, []).append(p.grad is not None)
    assert not any(stage["stem"]) and not any(stage["res2"])
    assert all(stage["res3"]) and all(stage["res4"])
    net.freeze_through = 0
    assert torch.equal(net(x), out)
    net.zero_grad()
    net(x).sum().backward()
    assert net.conv1.weight.grad is not None


# --------------------------------------------------------------------------
# one whole train step, four C4 families
# --------------------------------------------------------------------------

FAMILIES = ["plain_learn_nms", "plain", "plain_relation", "learn_nms_only"]


@contextlib.contextmanager
def _exact_trig_jax():
    """Route the JAX model's geometric bias to its jnp reference (autodiff
    gives its gradient), as tests/test_torch_flagship.py does."""
    import relation_tpu.models.relation as jrel

    def bias_ref(pos, k, b, scale=100.0):
        return jgb.geom_bias_reference(pos, k, b, scale)
    saved = (jrel.fused_geometric_bias, jgb.fused_geometric_bias)
    jrel.fused_geometric_bias = jgb.fused_geometric_bias = bias_ref
    try:
        yield
    finally:
        jrel.fused_geometric_bias, jgb.fused_geometric_bias = saved


def _jax_priorities(cfg, batch, step=0):
    """The uniform vectors the JAX step draws: fold_in(rng, step) ->
    split(B) -> split -> (r_anchor, r_sample); anchor_targets splits
    r_anchor into (fg, bg). BATCH_ROIS = -1 draws nothing from r_sample."""
    B, size = batch["image"].shape[0], batch["image"].shape[1]
    K = (size // 16) ** 2 * int(cfg.network.NUM_ANCHORS)
    rngs = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), step), B)
    out = []
    for b in range(B):
        r_anchor, _ = jax.random.split(rngs[b])
        k_fg, k_bg = jax.random.split(r_anchor)
        out.append({"anchor": (np.array(jax.random.uniform(k_fg, (K,))),
                               np.array(jax.random.uniform(k_bg, (K,))))})
    return out


@pytest.fixture(scope="module")
def jax_step():
    """family -> (cfg, params, flat params, flat new params, metrics) of one
    jitted JAX train step with the exact-trig geometric bias; each family
    is compiled and run once for the whole file."""
    from relation_tpu.core.trainer import (build_model, create_train_state,
                                           make_train_step)
    done = {}

    def run(family):
        if family in done:
            return done[family]
        cfg = family_cfg(family)
        with _exact_trig_jax():
            model = build_model(cfg, tiny=True)
            state = create_train_state(model, cfg, jax.random.PRNGKey(0),
                                       jnp.zeros((64, 64, 3)),
                                       jnp.asarray([64.0, 64.0, 1.0]))
            shapes = jax.tree.map(
                lambda p: jax.ShapeDtypeStruct(p.shape, p.dtype), state.params)
            params = synth_params(shapes)
            state = state.replace(params=params, opt_state=state.tx.init(params))
            state2, metrics = jax.jit(make_train_step(model, cfg))(
                state, jax.tree.map(jnp.asarray, _fixed_batch()))
            metrics = {k: float(v) for k, v in metrics.items()}
        done[family] = (cfg, params, flat_numpy(params),
                        flat_numpy(state2.params), metrics)
        return done[family]
    return run


def _port_step(cfg, params, fully_fused=False):
    from relation_tpu_torch.convert import to_jax_params
    from relation_tpu_torch.core.trainer import (create_train_state,
                                                 make_train_step)
    model = port_model(cfg, params)
    if fully_fused:
        model.learn_nms_head.NMSRelationModule_0.fully_fused = True
    state = create_train_state(model, cfg)
    batch = _fixed_batch()
    state, metrics = make_train_step(model, cfg, device="cpu")(
        state, batch, priorities=_jax_priorities(cfg, batch))
    assert state.step == 1
    return ({k: float(v) for k, v in metrics.items()},
            to_jax_params(model.state_dict()), state)


def _update_stats(before, after):
    sq, moved = 0.0, 0
    for k in before:
        d = after[k].astype(np.float64) - before[k].astype(np.float64)
        s = float(np.sum(d * d))
        sq += s
        moved += int(s > 0)
    return np.sqrt(sq), moved


@pytest.mark.parametrize("family", FAMILIES)
def test_train_step_matches_jax_and_golden(jax_step, family):
    """One step of the port on synth_params and _fixed_batch with the
    JAX-drawn priorities.

    (i) Against the JAX step run here (exact-trig bias): every metric at
    1e-4 relative; every updated leaf within 1e-6 + 1e-3 of its update;
    frozen leaves bit-equal. The pair_pos_fc1 leaves get 5e-6 instead of
    1e-6: their gradient holds g/acc of pairs close to the 1e-6 clamp (one
    pair of this batch has acc = 6e-5), and acc moves with the last bit of
    the proposals' corners (sin/cos of 100 * log-ratios), so the two
    frameworks' f32 roundings show up amplified there.
    (ii) Against tests/golden/train_<family>.npz (made with the Pallas
    kernels in interpret mode): metrics and update_norm at 1e-3 relative,
    update_count equal."""
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
    with np.load(f"{GOLDEN_DIR}/train_{family}.npz") as z:
        golden = {k: float(z[k]) for k in z.files}
    norm, moved = _update_stats(before, after)
    assert moved == golden.pop("update_count")
    assert norm == pytest.approx(golden.pop("update_norm"), rel=1e-3)
    assert set(golden) == set(metrics)
    for k, want in golden.items():
        assert metrics[k] == pytest.approx(want, rel=1e-3, abs=1e-6), k


def test_fully_fused_step_equals_the_dense_step(jax_step):
    """fully_fused=True (the single fused attention; on the CPU its plain
    version) against the default dense path on the flagship family: metrics
    at 1e-4 relative, every leaf's update within 1e-4 of the largest update
    of that leaf."""
    cfg, params, before, _, _ = jax_step("plain_learn_nms")
    dense_m, dense, _ = _port_step(cfg, params)
    fused_m, fused, state = _port_step(cfg, params, fully_fused=True)
    assert state.model.learn_nms_head.NMSRelationModule_0.fully_fused
    for k, want in dense_m.items():
        assert fused_m[k] == pytest.approx(want, rel=1e-4, abs=1e-7), k
    for k in before:
        top = np.abs(dense[k] - before[k]).max()
        np.testing.assert_allclose(fused[k] - before[k], dense[k] - before[k],
                                   rtol=0, atol=1e-4 * top + 1e-9, err_msg=k)


def test_train_step_entry_points_refuse_and_repeat():
    """make_train_step defaults to the card and raises where there is none;
    an FPN symbol for a C4 model, a DCN symbol for a model built without the
    DCN parts, a stop_after cut that the JAX step does not have
    and a learned-NMS config with sampled rois raise; a second step moves the parameters again and lowers
    nothing to NaN; no_grad leaves the parameters alone; generator-drawn
    priorities repeat under one seed; uint8 images take the device-side
    mean subtraction."""
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.trainer import (build_model, create_train_state,
                                                 make_train_step, refreeze_state)
    cfg = family_cfg("plain_learn_nms")
    model = init_params(build_model(cfg, tiny=True, device="cpu"), seed=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_train_step(model, cfg)
    with pytest.raises(ValueError, match="stop_after"):
        make_train_step(model, cfg, stop_after="lnms_logit", device="cpu")
    bad = cfg.copy()
    bad.TRAIN.BATCH_ROIS = 16
    with pytest.raises(ValueError, match="BATCH_ROIS"):
        make_train_step(model, bad, device="cpu")
    bad = cfg.copy()
    bad.symbol = bad.symbol.replace("rcnn", "rcnn_fpn")     # a C4 model
    with pytest.raises(ValueError, match="C4"):
        make_train_step(model, bad, device="cpu")
    bad.symbol = cfg.symbol.replace("rcnn", "rcnn_dcn")     # a non-DCN model
    with pytest.raises(ValueError, match="DCN"):
        make_train_step(model, bad, device="cpu")

    batch = _fixed_batch()
    step = make_train_step(model, cfg, device="cpu")

    def run(seed):
        init_params(model, seed=1)
        state = create_train_state(model, cfg, seed=seed)
        out = []
        for _ in range(2):
            state, m = step(state, batch)
            out.append({k: float(v) for k, v in m.items()})
        return state, out
    state, first = run(5)
    _, again = run(5)
    assert first == again and state.step == 2
    assert all(np.isfinite(v) for m in first for v in m.values())
    assert first[1]["total_loss"] != first[0]["total_loss"]
    assert all(float(v.abs().max()) > 0 for v in state.trace.values())

    sd = {k: v.clone() for k, v in model.state_dict().items()}
    _, m = make_train_step(model, cfg, no_grad=True, device="cpu")(state, batch)
    assert np.isfinite(float(m["total_loss"])) and state.step == 3
    assert all(torch.equal(v, sd[k]) for k, v in model.state_dict().items())

    # a refrozen state trains the learned-NMS branch only
    state = refreeze_state(state, cfg, ["tiny", "rpn", "conv_new_1", "fc_new",
                                        "cls_score", "bbox_pred", "relation"])
    frozen_step = make_train_step(model, cfg, device="cpu", fixed_prefixes=[
        "tiny", "rpn", "conv_new_1", "fc_new", "cls_score", "bbox_pred",
        "relation"])
    frozen_step(state, batch)
    moved = {k for k, v in model.state_dict().items() if not torch.equal(v, sd[k])}
    assert moved and all(k.startswith("learn_nms_head") for k in moved)

    u8 = dict(batch, image=np.clip(batch["image"] + 110, 0, 255).astype(np.uint8))
    _, m = make_train_step(model, cfg, no_grad=True, device="cpu")(state, u8)
    assert np.isfinite(float(m["total_loss"]))


def test_sampled_roi_mode_runs_through_the_step():
    """TRAIN.BATCH_ROIS >= 0 (the plain families' sampled mode): the step
    takes "sample" priorities and a generator alike."""
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.trainer import (build_model, create_train_state,
                                                 make_train_step)
    cfg = family_cfg("plain")
    cfg.TRAIN.BATCH_ROIS = 16
    cfg.TRAIN.ENABLE_OHEM = False
    model = init_params(build_model(cfg, tiny=True, device="cpu"), seed=2)
    step = make_train_step(model, cfg, device="cpu")
    batch = _fixed_batch()
    rng = np.random.RandomState(0)
    R = int(cfg.TRAIN.RPN_POST_NMS_TOP_N) + batch["gt_boxes"].shape[1]
    prio = [{"anchor": tuple(rng.uniform(0, 1, (2, 96)).astype(np.float32)),
             "sample": tuple(rng.uniform(0, 1, (4, R)).astype(np.float32))}
            for _ in range(2)]
    state = create_train_state(model, cfg)
    _, a = step(state, batch, priorities=prio)
    init_params(model, seed=2)
    _, b = step(create_train_state(model, cfg), batch, priorities=prio)
    assert float(a["total_loss"]) == float(b["total_loss"])
    _, c = step(state, batch)
    assert np.isfinite(float(c["total_loss"]))
