"""Port parity of the DCN slice and the classic NMS tail: relation_tpu (JAX,
CPU) against relation_tpu_torch (PyTorch, CPU, plain versions of the kernels)
on the same numpy inputs from a seed.

- classwise_nms against the JAX CPU route and the Pallas route in interpret
  mode, soft_nms and greedy_nms_topk against JAX;
- the plain deformable col2im against the Pallas col2im kernel in interpret
  mode (fed with hat rows of the same coordinates) and the scatter VJP;
- the deformable conv, forward and three gradients, and the deformable PSROI
  pool, forward and two gradients, against JAX and the numpy oracle;
- DCNBottleneck and a narrow deformable res5 with non-zero offset weights;
- the golden detections of the DCN families and of the families the classic
  tail opens.

Every tolerance is stated where it is used. f32 throughout.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tests.test_torch_helpers import flat_numpy, jax_tiny_family, n, port_model, t
from tests.test_deform import np_dpsroi_oracle
from tests.test_golden_e2e import _fixed_input, _load_fixture, family_cfg
from relation_tpu.ops import deform as jd, nms as jn
from relation_tpu.ops.pallas.dconv_col2im import (dconv_col2im as j_col2im,
                                                  hat_rows_masked)
from relation_tpu_torch.convert import from_jax_params, to_jax_params
from relation_tpu_torch.core.predictor import make_predict_fn
from relation_tpu_torch.ops import deform as td, nms as tn
from relation_tpu_torch.ops.kernels import dconv_col2im as tk

J = jnp.asarray


def _boxes(rng, shape, size=200.0):
    xy = rng.uniform(0, size, shape + (2,))
    wh = rng.uniform(4, 80, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# --------------------------------------------------------------------------
# the classic NMS tail
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_boxes,max_keep", [(40, None), (40, 6), (300, None),
                                              (300, 5)])
def test_classwise_nms_matches_jax_and_pallas(n_boxes, max_keep):
    """Keep masks equal, bit for bit, to the Pallas route in interpret mode
    (the route the port follows: sort, pad, one kernel call, un-sort), with
    scores rounded to one decimal so that ties abound. Against the JAX CPU
    route (one 512-box block a class, so no early exit): equal where no
    early exit happens, and equal on the first ``max_keep`` kept boxes of
    every class where it does."""
    rng = np.random.RandomState(n_boxes + (max_keep or 0))
    C = 3
    boxes = _boxes(rng, (C, n_boxes))
    scores = np.round(rng.uniform(0, 1, (C, n_boxes)), 1).astype(np.float32)
    valid = rng.uniform(0, 1, (C, n_boxes)) > 0.1
    got = n(tn.classwise_nms(t(boxes), t(scores), 0.4, 0.15, t(valid), max_keep))
    v = J(valid) & (J(scores) > 0.15)
    pallas = np.asarray(jn._classwise_nms_pallas(J(boxes), J(scores), v, 0.4,
                                                 max_keep, interpret=True))
    np.testing.assert_array_equal(got, pallas)
    cpu = np.asarray(jn.classwise_nms(J(boxes), J(scores), 0.4, 0.15, J(valid),
                                      max_keep))
    assert got.any() and not got[~(valid & (scores > 0.15))].any()
    for c in range(C):
        order = np.argsort(-np.where(valid[c] & (scores[c] > 0.15), scores[c],
                                     -1e10), kind="stable")
        a, b = order[got[c][order]], order[cpu[c][order]]
        k = len(b) if max_keep is None else min(max_keep, len(b))
        np.testing.assert_array_equal(a[:k], b[:k])
        if max_keep is None or n_boxes < 256:
            np.testing.assert_array_equal(got[c], cpu[c])
    # boxes shared by the classes
    shared = n(tn.classwise_nms(t(boxes[0]), t(scores), 0.4, 0.15, t(valid),
                                max_keep))
    np.testing.assert_array_equal(shared[0], got[0])


@pytest.mark.parametrize("sigma", [0.6, 10.0])
def test_soft_nms_matches_jax(sigma):
    """Indices equal, scores to 1e-6, batched over classes against the JAX
    function vmapped; scores rounded so the argmax meets ties."""
    rng = np.random.RandomState(3)
    C, N, D = 4, 30, 12
    boxes = _boxes(rng, (C, N), size=120.0)
    scores = np.round(rng.uniform(0, 1, (C, N)), 1).astype(np.float32)
    valid = rng.uniform(0, 1, (C, N)) > 0.2
    want = jax.vmap(lambda b, s, v: jn.soft_nms(b, s, sigma, D, v,
                                                score_floor=0.05))(
        J(boxes), J(scores), J(valid))
    got = tn.soft_nms(t(boxes), t(scores), sigma, D, t(valid), score_floor=0.05)
    np.testing.assert_array_equal(n(got[0]), np.asarray(want[0]))
    np.testing.assert_allclose(n(got[1]), np.asarray(want[1]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(n(got[2]), np.asarray(want[2]))
    one = tn.soft_nms(t(boxes[1]), t(scores[1]), sigma, D, t(valid[1]),
                      score_floor=0.05)
    np.testing.assert_array_equal(n(one[0]), np.asarray(want[0][1]))
    # more iterations than valid boxes: the rest come back invalid
    few = tn.soft_nms(t(boxes[0, :5]), t(scores[0, :5]), sigma, 8)
    jfew = jn.soft_nms(J(boxes[0, :5]), J(scores[0, :5]), sigma, 8)
    np.testing.assert_array_equal(n(few[2]), np.asarray(jfew[2]))
    assert not n(few[2])[5:].any()


@pytest.mark.parametrize("top_k,thresh", [(5, 0.5), (40, 0.02)])
def test_greedy_nms_topk_matches_jax(top_k, thresh):
    """Indices and the real mask equal; with the low threshold fewer than
    top_k boxes survive and the tail cycles through the kept ones."""
    rng = np.random.RandomState(top_k)
    boxes = _boxes(rng, (60,), size=100.0)
    scores = np.round(rng.uniform(0, 1, 60), 1).astype(np.float32)
    valid = rng.uniform(0, 1, 60) > 0.2
    want = jn.greedy_nms_topk(J(boxes), J(scores), thresh, top_k, J(valid))
    got = tn.greedy_nms_topk(t(boxes), t(scores), thresh, top_k, t(valid))
    np.testing.assert_array_equal(n(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(n(got[1]), np.asarray(want[1]))
    assert n(got[1]).any() and (top_k == 5 or not n(got[1]).all())


# --------------------------------------------------------------------------
# deformable col2im
# --------------------------------------------------------------------------

def _col2im_case(rng, B, H, W, G, cg, kk=9):
    """Coordinates in the port's [B, S, G] layout with offsets that leave
    the map on every side, and rows exactly on an integer, on -1 and on H."""
    Q = H * W
    yy = rng.uniform(-2.5, H + 1.5, (B, Q * kk, G)).astype(np.float32)
    xx = rng.uniform(-2.5, W + 1.5, (B, Q * kk, G)).astype(np.float32)
    yy[:, 0::17] = np.round(yy[:, 0::17])
    xx[:, 1::17] = np.round(xx[:, 1::17])
    yy[:, 2::29], yy[:, 3::29] = -1.0, float(H)
    xx[:, 4::29], xx[:, 5::29] = -1.0, float(W)
    yy[:, 6::29], xx[:, 6::29] = H - 1.0, W - 1.0
    inside = (yy > -1.0) & (yy < H) & (xx > -1.0) & (xx < W)
    d = rng.randn(B, Q * kk, G, cg).astype(np.float32)
    return np.where(inside, yy, 0), np.where(inside, xx, 0), inside, d


@pytest.mark.parametrize("B,H,W,G,cg", [(2, 6, 7, 2, 4), (1, 8, 8, 4, 8)])
def test_plain_col2im_matches_pallas_kernel_and_dense_form(B, H, W, G, cg):
    """The port's plain col2im against (i) the Pallas kernel in interpret
    mode fed with hat_rows_masked of the same coordinates, through the glue
    of relation_tpu/ops/deform.py:370-392 (regroup to (b, g)-major rows, pad
    R to 256, un-group), (ii) the dense hat-row contraction in float64, and
    (iii) the scatter VJP of the JAX package (jax.vjp of its flat col
    gather on the same coordinates), the dx its CPU tests run.
    1e-5 of the maximum: f32 sums of some tens of terms in another order."""
    rng = np.random.RandomState(B * 100 + H)
    yz, xz, inside, d = _col2im_case(rng, B, H, W, G, cg)
    got = n(tk.dconv_col2im(t(yz), t(xz), t(inside), t(d), H, W))
    assert got.shape == (B, H, W, G * cg)

    def bg_rows(a):                       # [B, S, G(, cg)] -> [B*G, S(, cg)]
        return np.moveaxis(a, 2, 1).reshape((B * G, a.shape[1]) + a.shape[3:])
    by = hat_rows_masked(J(bg_rows(yz)), J(bg_rows(inside)), H, jnp.float32)
    bx = hat_rows_masked(J(bg_rows(xz)), J(bg_rows(inside)), W, jnp.float32)
    rows = J(bg_rows(d))
    pad = (-by.shape[1]) % 256
    by, bx, rows = (jnp.pad(a, ((0, 0), (0, pad), (0, 0))) for a in (by, bx, rows))
    out = np.asarray(j_col2im(by, bx, rows, H, W, interpret=True))
    want = out.reshape(B, G, H, W, cg).transpose(0, 2, 3, 1, 4).reshape(got.shape)
    top = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * top)
    dense = np.einsum("brh,brw,brc->bhwc", np.asarray(by, np.float64),
                      np.asarray(bx, np.float64), np.asarray(rows, np.float64))
    dense = dense.reshape(B, G, H, W, cg).transpose(0, 2, 3, 1, 4).reshape(got.shape)
    np.testing.assert_allclose(got, dense, rtol=0, atol=1e-5 * top)
    # sample s = q * 9 + tap: [B, S, G] -> the JAX op's [B, kk, G, Ho, Wo]
    def j_coords(a):
        return J(a.reshape(B, H * W, 9, G).transpose(0, 2, 3, 1)
                 .reshape(B, 9, G, H, W))
    yy = j_coords(np.where(inside, yz, -5.0))          # outside stays outside
    _, pull = jax.vjp(lambda xv: jd._dconv_col_flat(xv, yy, j_coords(xz), G),
                      jnp.zeros((B, H, W, G * cg), jnp.float32))
    scatter = np.asarray(pull(J(d.reshape(B, H, W, 9, G * cg)))[0])
    np.testing.assert_allclose(got, scatter, rtol=0, atol=1e-5 * top)
    # a pixel that no sample touches stays exactly zero
    far = np.zeros_like(yz) + 0.25
    alone = n(tk.dconv_col2im(t(far), t(far), t(np.ones_like(inside)), t(d), H, W))
    assert alone[:, 2:].any() == False and alone[:, :2, :2].all()  # noqa: E712


def test_col2im_corner_weights_equal_hat_rows():
    """On an integer row one corner carries all the weight; in the
    zero-extension bands (-1, 0) and (H-1, H) one corner survives; -1 and H
    themselves are outside."""
    H, W = 5, 6
    ys = np.asarray([2.0, -0.25, H - 0.5, -1.0, float(H), H - 1.0], np.float32)
    xs = np.full_like(ys, 1.5)
    inside = (ys > -1) & (ys < H)
    pix, w = tk.corner_weights(t(np.where(inside, ys, 0)), t(np.where(inside, xs, 0)),
                               t(inside), H, W)
    hat_y = np.asarray(hat_rows_masked(J(np.where(inside, ys, 0)), J(inside), H,
                                       jnp.float32))
    hat_x = np.asarray(hat_rows_masked(J(np.where(inside, xs, 0)), J(inside), W,
                                       jnp.float32))
    dense = np.zeros((len(ys), H * W), np.float32)
    for k in range(4):
        np.add.at(dense, (np.arange(len(ys)), n(pix[k])), n(w[k]))
    np.testing.assert_allclose(
        dense, (hat_y[:, :, None] * hat_x[:, None, :]).reshape(len(ys), -1),
        rtol=0, atol=1e-7)
    assert dense[3].sum() == 0 and dense[4].sum() == 0
    np.testing.assert_allclose(dense.sum(1), [1, 0.75, 0.5, 0, 0, 1], atol=1e-6)


# --------------------------------------------------------------------------
# deformable conv
# --------------------------------------------------------------------------

@pytest.mark.parametrize("G", [1, 4])
def test_deformable_conv_batched_matches_jax(G):
    """Forward to 1e-5; dx, doffset and dw against jax.grad of the JAX op to
    1e-5 of each gradient's maximum. B=2, random non-integer offsets of a
    few pixels that leave the map on every side, one position pushed fully
    outside. Offsets are kept 1e-3 away from integers: the offset gradient
    jumps where a sample crosses a pixel row, and the two frameworks may
    round a coordinate to different sides of it."""
    rng = np.random.RandomState(G)
    B, H, W, C, Co = 2, 9, 11, 8, 6
    x = rng.randn(B, H, W, C).astype(np.float32)
    w = (rng.randn(3, 3, C, Co) * 0.1).astype(np.float32)
    off = (rng.randn(B, H, W, G * 18) * 2.5 + 0.3).astype(np.float32)
    frac = off - np.round(off)
    off = np.where(np.abs(frac) < 1e-3, off + 0.01, off).astype(np.float32)
    off[0, 0, 0] = 50.0
    dout = rng.randn(B, H, W, Co).astype(np.float32)
    kw = dict(kernel=3, dilation=2, num_groups=G)

    def loss(x_, o_, w_):
        return jnp.sum(jd.deformable_conv_batched(x_, o_, w_, **kw) * dout)
    want = jd.deformable_conv_batched(J(x), J(off), J(w), **kw)
    grads = jax.grad(loss, argnums=(0, 1, 2))(J(x), J(off), J(w))
    ins = [t(a).requires_grad_(True) for a in (x, off, w)]
    out = td.deformable_conv_batched(*ins, **kw)
    np.testing.assert_allclose(n(out), np.asarray(want), rtol=1e-5, atol=1e-5)
    got = torch.autograd.grad(out, ins, t(dout))
    yy, _ = td._tap_coords(ins[1].detach(), 3, 1, 2, 2, G)
    assert float(yy.min()) < -1 and float(yy.max()) > H     # leaves the map
    for name, g, r in zip(("dx", "doffset", "dw"), got, grads):
        r = np.asarray(r)
        assert np.abs(r).max() > 0
        np.testing.assert_allclose(n(g), r, rtol=0, atol=1e-5 * np.abs(r).max(),
                                   err_msg=name)
    assert not n(got[1])[0, 0, 0].any()          # fully outside: no gradient
    # the one-image wrapper, and the hand-written backward against autograd
    # of the gathers
    one = td.deformable_conv(t(x[1]), t(off[1]), t(w), **kw)
    np.testing.assert_allclose(n(one), np.asarray(want[1]), rtol=1e-5, atol=1e-5)
    yy, xx = td._tap_coords(ins[1], 3, 1, 2, 2, G)
    auto = td._col(ins[0], yy, xx, G).reshape(B * H * W, -1) @ ins[2].reshape(-1, Co)
    for name, g, a in zip(("dx", "doffset", "dw"), got, torch.autograd.grad(
            auto.view(B, H, W, Co), ins, t(dout))):
        np.testing.assert_allclose(n(g), n(a), rtol=0,
                                   atol=1e-5 * float(a.abs().max()), err_msg=name)


def test_deformable_conv_refuses_bad_shapes():
    x, w = torch.zeros(1, 4, 4, 6), torch.zeros(3, 3, 6, 2)
    with pytest.raises(ValueError):
        td.deformable_conv_batched(x, torch.zeros(1, 4, 4, 36), w, num_groups=4)
    with pytest.raises(ValueError):
        td.deformable_conv_batched(x, torch.zeros(1, 4, 4, 30), w, num_groups=2)


# --------------------------------------------------------------------------
# deformable PSROI pooling
# --------------------------------------------------------------------------

def _psroi_case(rng, R=6, H=12, W=16, C=5):
    feat = rng.randn(H, W, C).astype(np.float32)
    x1, y1 = rng.uniform(-20, 150, R), rng.uniform(-20, 100, R)
    rois = np.stack([x1, y1, x1 + rng.uniform(20, 90, R),
                     y1 + rng.uniform(20, 140, R)], 1).astype(np.float32)
    rois[-1] = [400, 400, 420, 430]            # beyond the map: count 0
    trans = (rng.randn(R, 2, 7, 7) * 0.5).astype(np.float32)
    return feat, rois, trans


@pytest.mark.parametrize("with_trans", [False, True])
def test_deformable_psroi_pool_matches_jax_and_oracle(with_trans):
    """G == 1 (the form the heads use): against the JAX op (its separable
    hat-row einsums) and the numpy oracle of the original CUDA kernel to
    1e-5; the gradients to the feature map and to trans against jax.grad to
    1e-5 of their maxima. ROIs overlap the border and one lies beyond it."""
    rng = np.random.RandomState(5)
    feat, rois, trans = _psroi_case(rng)
    tr = trans if with_trans else None
    g_out = rng.randn(len(rois), 7, 7, feat.shape[2]).astype(np.float32)

    def j_pool(f, tt):
        return jd.deformable_psroi_pool(f, J(rois), tt, 1 / 16)
    want = np.asarray(j_pool(J(feat), None if tr is None else J(tr)))
    f_t = t(feat).requires_grad_(True)
    tr_t = None if tr is None else t(tr).requires_grad_(True)
    out = td.deformable_psroi_pool(f_t, t(rois), tr_t, 1 / 16)
    np.testing.assert_allclose(n(out), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(out), np_dpsroi_oracle(feat, rois, tr, 1 / 16),
                               rtol=1e-5, atol=1e-5)
    assert not n(out)[-1].any() and n(out)[0].any()
    if tr is None:
        want_g = [jax.grad(lambda f: jnp.sum(j_pool(f, None) * g_out))(J(feat))]
        got_g = torch.autograd.grad(out, [f_t], t(g_out))
    else:
        want_g = jax.grad(lambda f, tt: jnp.sum(j_pool(f, tt) * g_out),
                          argnums=(0, 1))(J(feat), J(tr))
        got_g = torch.autograd.grad(out, [f_t, tr_t], t(g_out))
    for name, g, r in zip(("dfeat", "dtrans"), got_g, want_g):
        r = np.asarray(r)
        assert np.abs(r).max() > 0
        np.testing.assert_allclose(n(g), r, rtol=0, atol=1e-5 * np.abs(r).max(),
                                   err_msg=name)


@pytest.mark.parametrize("with_trans", [False, True])
def test_deformable_psroi_pool_group_size_matches_jax(with_trans):
    """group_size 3, output_dim 2, P 4, part_size 2, 2 samples a part: the
    position-sensitive channel choice (ctop*G + gh)*G + gw, against the JAX
    branch with _bilinear_clamp_all to 1e-5, and its gradients."""
    rng = np.random.RandomState(9)
    G, outdim, P = 3, 2, 4
    feat, rois, _ = _psroi_case(rng, C=outdim * G * G)
    tr = (rng.randn(len(rois), 2, 2, 2) * 0.5).astype(np.float32) \
        if with_trans else None
    kw = dict(pooled_size=P, group_size=G, sample_per_part=2, output_dim=outdim,
              part_size=2, trans_std=0.2)
    g_out = rng.randn(len(rois), P, P, outdim).astype(np.float32)

    def j_pool(f, tt):
        return jd.deformable_psroi_pool(f, J(rois), tt, 1 / 16, **kw)
    want = np.asarray(j_pool(J(feat), None if tr is None else J(tr)))
    f_t = t(feat).requires_grad_(True)
    tr_t = None if tr is None else t(tr).requires_grad_(True)
    out = td.deformable_psroi_pool(f_t, t(rois), tr_t, 1 / 16, **kw)
    assert out.shape == (len(rois), P, P, outdim)
    np.testing.assert_allclose(n(out), want, rtol=1e-5, atol=1e-5)
    args = (J(feat),) if tr is None else (J(feat), J(tr))
    want_g = jax.grad(lambda *a: jnp.sum(j_pool(a[0], a[1] if tr is not None
                                                else None) * g_out),
                      argnums=tuple(range(len(args))))(*args)
    got_g = torch.autograd.grad(out, [f_t] if tr is None else [f_t, tr_t],
                                t(g_out))
    for g, r in zip(got_g, want_g):
        r = np.asarray(r)
        np.testing.assert_allclose(n(g), r, rtol=0, atol=1e-5 * np.abs(r).max())
    # constant planes identify the channel each bin reads
    planes = np.tile(np.arange(outdim * G * G, dtype=np.float32), (9, 9, 1))
    got = n(td.deformable_psroi_pool(t(planes), t(np.asarray([[0, 0, 143, 143]],
                                                             np.float32)),
                                     None, 1 / 16, pooled_size=3, group_size=G,
                                     sample_per_part=2, output_dim=outdim))
    for ph in range(3):
        for pw in range(3):
            for ctop in range(outdim):
                assert got[0, ph, pw, ctop] == (ctop * G + ph) * G + pw


# --------------------------------------------------------------------------
# DCNBottleneck and the deformable res5
# --------------------------------------------------------------------------

def _nonzero_params(shapes, seed):
    """Random f32 leaves of the given flax shape tree; the offset convs get
    weights large enough to move the samples by a few pixels."""
    rng = np.random.RandomState(seed)
    flat = flat_numpy_shapes(shapes)
    out = {}
    for k in sorted(flat):
        shape = tuple(flat[k].shape)
        leaf = k.rsplit("/", 1)[-1]
        if leaf == "moving_var":
            v = np.abs(rng.standard_normal(shape)) * 0.1 + 0.5
        elif leaf == "gamma":
            v = 1 + 0.05 * rng.standard_normal(shape)
        elif "_offset/" in k:
            v = rng.standard_normal(shape) * 0.15
        else:
            v = rng.standard_normal(shape) * 0.1
        out[k] = v.astype(np.float32)
    return out


def _unflatten(flat):
    from flax.traverse_util import unflatten_dict
    return unflatten_dict({tuple(k.split("/")): J(v) for k, v in flat.items()})


def _offset_fields(module, params, x):
    """The offset convs' outputs of a JAX module application."""
    _, state = module.apply({"params": params}, x, capture_intermediates=(
        lambda mdl, _: mdl.name is not None and mdl.name.endswith("_offset")))
    return [np.asarray(v) for v in jax.tree.leaves(state["intermediates"])]


def test_dcn_bottleneck_matches_jax_with_nonzero_offsets():
    """A DCNBottleneck (mid 8, out 16, projection, 4 deformable groups) with
    non-zero offset-conv weights and bias, B=2: output to 1e-5, and the
    gradient of every parameter and of the input against jax.grad to 1e-5 of
    its maximum, through from_jax_params / to_jax_params (bare rank-4
    weight, offset conv kernel and bias). The goldens' tiny model has no
    res5, so no committed fixture runs a deformable conv."""
    from relation_tpu.models.backbone import DCNBottleneck as JBlock
    from relation_tpu_torch.models.backbone import DCNBottleneck
    rng = np.random.RandomState(2)
    jblock = JBlock(prefix="5a", mid=8, out=16, dilation=2, deform_groups=4,
                    has_proj=True, dtype=jnp.float32)
    x = rng.randn(2, 7, 6, 16).astype(np.float32)
    shapes = jax.eval_shape(lambda k: jblock.init(k, J(x)),
                            jax.random.PRNGKey(0))["params"]
    flat = _nonzero_params(shapes, 4)
    assert flat["res5a_branch2b_offset/bias"].shape == (72,)
    assert flat["res5a_branch2b_weight"].shape == (3, 3, 8, 8)
    params = _unflatten(flat)
    offs = _offset_fields(jblock, params, J(x))
    assert len(offs) == 1 and np.abs(offs[0]).max() > 1.0      # pixels, not zero
    block = DCNBottleneck("5a", 16, 8, 16, has_proj=True)
    block.load_state_dict(from_jax_params(flat, block))
    g_out = rng.randn(2, 7, 6, 16).astype(np.float32)

    want = np.asarray(jblock.apply({"params": params}, J(x)))
    gp, gx = jax.grad(lambda p, xx: jnp.sum(jblock.apply({"params": p}, xx) * g_out),
                      argnums=(0, 1))(params, J(x))
    for p in block.parameters():
        p.requires_grad_(True)
    x_t = t(x).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    out = block(x_t)
    np.testing.assert_allclose(n(out.permute(0, 2, 3, 1)), want, rtol=1e-5, atol=1e-5)
    out.backward(t(g_out).permute(0, 3, 1, 2))
    np.testing.assert_allclose(n(x_t.grad.permute(0, 2, 3, 1)), np.asarray(gx),
                               rtol=0, atol=1e-5 * np.abs(np.asarray(gx)).max())
    got = to_jax_params({k: p.grad for k, p in block.named_parameters()})
    want_g = flat_numpy(gp)
    trained = [k for k in want_g if k.rsplit("/", 1)[-1] not in (
        "gamma", "beta", "moving_mean", "moving_var")]
    assert set(got) == set(trained)
    for k in trained:
        assert np.abs(want_g[k]).max() > 0, k
        np.testing.assert_allclose(got[k], want_g[k], rtol=0,
                                   atol=1e-5 * np.abs(want_g[k]).max(), err_msg=k)
    # the round trip of the state dict is exact
    back = to_jax_params(block.state_dict())
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


def test_narrow_deformable_res5_matches_jax():
    """Three DCNBottlenecks in a row (the module tree of ResNet101C5DCN,
    narrowed to 16 -> mid 8 -> 16 channels) with non-zero offsets: every
    unit's offsets and the output against the JAX blocks to 1e-5, and the
    flax paths of the full-width ResNet101C5DCN land on the port's keys."""
    from relation_tpu.models.backbone import (DCNBottleneck as JBlock,
                                              ResNet101C5DCN as JC5)
    from relation_tpu_torch.models.backbone import ResNet101C5DCN
    rng = np.random.RandomState(6)
    x = rng.randn(1, 8, 9, 16).astype(np.float32)
    net = ResNet101C5DCN(cin=16, mid=8, out=16)
    h = J(x)
    flat_all = {}
    for i, name in enumerate(("5a", "5b", "5c")):
        jblock = JBlock(prefix=name, mid=8, out=16, has_proj=(i == 0),
                        dtype=jnp.float32)
        shapes = jax.eval_shape(lambda k: jblock.init(k, h),
                                jax.random.PRNGKey(0))["params"]
        flat = _nonzero_params(shapes, 10 + i)
        params = _unflatten(flat)
        assert np.abs(_offset_fields(jblock, params, h)[0]).max() > 0.5
        h = jblock.apply({"params": params}, h)
        flat_all.update({f"DCNBottleneck_{i}/{k}": v for k, v in flat.items()})
    net.load_state_dict(from_jax_params(flat_all, net))
    got = net(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(n(got), np.asarray(h), rtol=1e-5, atol=1e-5)
    full = jax.eval_shape(lambda k: JC5(dtype=jnp.float32).init(
        k, jnp.zeros((1, 4, 4, 1024))), jax.random.PRNGKey(0))["params"]
    with torch.device("meta"):
        wide = ResNet101C5DCN()
    sd = from_jax_params({k: np.broadcast_to(np.float32(0), v.shape)
                          for k, v in flat_numpy_shapes(full).items()}, wide)
    assert len(sd) == len(wide.state_dict()) == 3 * 17 + 5
    assert sd["DCNBottleneck_1.res5b_branch2b_weight"].shape == (512, 512, 3, 3)
    assert sd["DCNBottleneck_0.res5a_branch2b_offset.weight"].shape == (72, 512, 3, 3)


def flat_numpy_shapes(tree):
    from flax.traverse_util import flatten_dict
    return flatten_dict(tree, sep="/")


# --------------------------------------------------------------------------
# golden detections
# --------------------------------------------------------------------------

def _check_dets(got, want, box_tol=1e-2, score_tol=1e-4):
    """The bands of tests/test_torch_flagship.py: same classes in the same
    order, scores within 1e-4, boxes within 1e-2 px."""
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0, atol=score_tol)
    np.testing.assert_allclose(got[:, 2:], want[:, 2:], rtol=0, atol=box_tol)


@pytest.mark.parametrize("family", ["dcn", "dcn_relation", "dcn_learn_nms",
                                    "plain", "plain_relation", "learn_nms_only"])
def test_golden_detections(family):
    """The committed golden of each family the slice opens (JAX, Pallas
    kernels in interpret mode), from synth_params carried across by
    from_jax_params: the DCN families (deformable PSROI head with a non-zero
    offset FC; the tiny trunk has no res5) and the three families that only
    lacked the classic NMS tail."""
    cfg = family_cfg(family)
    _, params = jax_tiny_family(cfg)
    model = port_model(cfg, params)
    assert model.dcn == family.startswith("dcn")
    if model.dcn:
        assert float(model.offset.weight.detach().abs().max()) > 0
    img, im_info = _fixed_input()
    out = make_predict_fn(model, cfg)(t(img), t(im_info))
    want = _load_fixture(family)
    assert (want[:, 1] > 0).any()
    _check_dets(n(out["dets"]), want)
    if not cfg.TEST.LEARN_NMS:
        assert out["cls_prob"].shape == (int(cfg.TEST.RPN_POST_NMS_TOP_N), 5)
        assert out["pred_boxes"].shape[0] == out["cls_prob"].shape[0]


@pytest.mark.parametrize("family", ["dcn", "plain_relation"])
def test_classic_tail_matches_jax_with_soft_nms_and_class_boxes(family):
    """The branches the goldens do not take: TEST.SOFTNMS, and per-class
    boxes (CLASS_AGNOSTIC False), against the JAX predict function run here:
    detections in the golden bands, cls_prob and pred_boxes to 1e-4."""
    from relation_tpu.core.predictor import make_predict_fn as j_make_predict
    cfg = family_cfg(family)
    cfg.TEST.SOFTNMS = family == "dcn"
    cfg.TEST.NMS = 0.6 if family == "dcn" else 0.3
    cfg.CLASS_AGNOSTIC = family == "dcn"
    jm, params = jax_tiny_family(cfg)
    model = port_model(cfg, params)
    img, im_info = _fixed_input()
    out = make_predict_fn(model, cfg)(t(img), t(im_info))
    want = j_make_predict(jm, cfg, (4, 4))(params, J(img), J(im_info))
    assert (np.asarray(want["dets"])[:, 1] > 0).any()
    _check_dets(n(out["dets"]), np.asarray(want["dets"]))
    for k in ("cls_prob", "pred_boxes"):
        np.testing.assert_allclose(n(out[k]), np.asarray(want[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


# --------------------------------------------------------------------------
# the entry point's family configs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("family,yaml", [
    ("dcn", "rcnn_dcn_end2end_8epoch"),
    ("dcn_relation", "rcnn_dcn_end2end_relation_8epoch"),
    ("dcn_learn_nms", "rcnn_dcn_end2end_relation_learn_nms_8epoch"),
    ("flagship", "rcnn_end2end_relation_learn_nms_8epoch"),
])
def test_family_cfg_follows_the_experiment_yaml(family, yaml):
    """entry.py::family_cfg against the experiment YAML of the family, read
    by the JAX package's loader: the symbol and every setting that shapes
    the model, the train step or the detection tail; and the model builds
    (shapes only) with or without the DCN parts as the symbol says."""
    import os
    from relation_tpu.config.defaults import load_config
    from relation_tpu_torch.core.trainer import build_model
    from relation_tpu_torch.entry import family_cfg
    here = os.path.dirname(os.path.abspath(__file__))
    want = load_config(os.path.join(
        here, "..", "experiments", "cfgs",
        f"resnet_v1_101_coco_trainvalminus_{yaml}.yaml"))
    got = family_cfg(family)
    assert got.symbol == want.symbol and got.CLASS_AGNOSTIC == want.CLASS_AGNOSTIC
    for sec, keys in (("network", ("ANCHOR_SCALES", "ANCHOR_RATIOS", "NUM_ANCHORS",
                                   "FIXED_PARAMS", "RCNN_FEAT_STRIDE")),
                      ("dataset", ("NUM_CLASSES",)),
                      ("TRAIN", ("LEARN_NMS", "BATCH_ROIS", "ENABLE_OHEM",
                                 "BATCH_ROIS_OHEM", "FIRST_N", "lr", "lr_step",
                                 "RPN_PRE_NMS_TOP_N", "RPN_POST_NMS_TOP_N",
                                 "BBOX_NORMALIZATION_PRECOMPUTED")),
                      ("TEST", ("LEARN_NMS", "NMS", "SOFTNMS", "max_per_image",
                                "RPN_PRE_NMS_TOP_N", "RPN_POST_NMS_TOP_N",
                                "FIRST_N", "LEARN_NMS_CLASS_SCORE_TH"))):
        for k in keys:
            a, b = got[sec][k], want[sec][k]
            assert (list(a) == list(b)) if isinstance(a, (list, tuple)) else a == b, \
                f"{sec}.{k}: {a} != {b}"
    model = build_model(got, device="meta")
    assert model.dcn == family.startswith("dcn")
    assert model.use_learn_nms == bool(want.TEST.LEARN_NMS)
