"""Port parity of the fused ResNet-101 trunk: the identity-bottleneck stack
(ops/kernels/res4.py) and the projection bottleneck
(ops/kernels/bottleneck_proj.py) against relation_tpu's Pallas kernels in
interpret mode, the BN folds against relation_tpu's, ResNet101C4's
res4_folded / fuse_res4 / trunk_folded dispatch at full depth, and the
flagship's predict(..., res4_folded) against the JAX make_predict_fn. On the
CPU the port's kernel functions run their plain versions; the CUDA kernels
are held against those on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances: in f32 the port and JAX compute the same f32 math in other
summation orders, held at 1e-4 of the largest element. In bf16 both round
the activations at the same points, but a different f32 sum can round one
element to the neighbouring bf16 value and the difference then travels
through the later blocks; the bands stated there are the measured ones with
room to spare. The fused trunk against the conv trunk keeps the JAX
package's own bands (tests/test_pallas_kernels.py): the fold scales the
weights before the bf16 cast, the conv path after the conv.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from flax.traverse_util import unflatten_dict

from tests.test_torch_helpers import n, t
from relation_tpu.models.backbone import (ResNet101C4 as JC4,
                                          fold_trunk_params as j_fold_trunk,
                                          image_to_s2d_planar as j_s2d)
from relation_tpu.ops.pallas.bottleneck_proj import (
    fused_proj_bottleneck as j_proj, proj_bottleneck_reference as j_proj_ref)
from relation_tpu.ops.pallas.res4 import (
    _fused_bottleneck_stack_impl as j_stack_impl,
    bottleneck_stack_reference as j_stack_ref)
from relation_tpu_torch.convert import init_params, to_jax_params
from relation_tpu_torch.core.predictor import (make_predict_fn,
                                               prepare_res4_folded)
from relation_tpu_torch.core.trainer import build_model
from relation_tpu_torch.entry import family_cfg
from relation_tpu_torch.models import backbone as bb
from relation_tpu_torch.models.backbone import (Conv2d, ResNet101C4,
                                                fold_res4_params,
                                                fold_trunk_params)
from relation_tpu_torch.ops.kernels import bottleneck_proj as BP
from relation_tpu_torch.ops.kernels import res4 as RS

BF16 = jnp.bfloat16


def _close(got, ref, rel=1e-4):
    """max |got - ref| <= rel * max |ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, top = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= rel * top, (err, top, rel)
    return err / top


def _corr(a, b):
    return np.corrcoef(np.ravel(a), np.ravel(b))[0, 1]


def _stack_args(rng, H=8, W=16, C=32, Cmid=16, B=3):
    return [(rng.randn(H, W, C)).astype(np.float32),
            (rng.randn(B, C, Cmid) * 0.1).astype(np.float32),
            (rng.randn(B, Cmid) * 0.1).astype(np.float32),
            (rng.randn(B, 9 * Cmid, Cmid) * 0.05).astype(np.float32),
            (rng.randn(B, Cmid) * 0.1).astype(np.float32),
            (rng.randn(B, Cmid, C) * 0.1).astype(np.float32),
            (rng.randn(B, C) * 0.1).astype(np.float32)]


def _as(args, dtype, bias_idx):
    """Map and weights in ``dtype`` (JAX and torch), biases f32."""
    jd = BF16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    j = [jnp.asarray(a, jnp.float32 if i in bias_idx else jd)
         for i, a in enumerate(args)]
    p = [t(a).to(torch.float32 if i in bias_idx else td)
         for i, a in enumerate(args)]
    return j, p


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_stack_matches_pallas_kernel_and_reference(dtype):
    rng = np.random.RandomState(0)
    jargs, pargs = _as(_stack_args(rng), dtype, (2, 4, 6))
    got = RS.fused_bottleneck_stack(*pargs)
    assert got.dtype == pargs[0].dtype and got.shape == (8, 16, 32)
    kernel = np.asarray(jax.jit(j_stack_impl, static_argnums=7)(*jargs, True),
                        np.float32)
    ref = np.asarray(j_stack_ref(*jargs), np.float32)
    if dtype == "f32":
        _close(n(got), kernel)
        _close(n(got), ref)
    else:
        # measured: a few elements one bf16 step apart (7.8e-3 of the
        # largest), the rest equal
        for want in (kernel, ref):
            _close(n(got), want, 2e-2)
            assert np.mean(n(got) != want) < 0.02
    torch.testing.assert_close(RS.bottleneck_stack_reference(*pargs), got,
                               rtol=0, atol=0)


@pytest.mark.parametrize("stride", [1, 2])
def test_proj_matches_pallas_kernel_and_reference(stride):
    rng = np.random.RandomState(stride)
    H, W, Cin, Cmid, Cout = 8, 16, 32, 16, 64
    args = [rng.randn(H, W, Cin), rng.randn(Cin, Cout) * 0.1,
            rng.randn(Cout) * 0.1, rng.randn(Cin, Cmid) * 0.1,
            rng.randn(Cmid) * 0.1, rng.randn(9 * Cmid, Cmid) * 0.05,
            rng.randn(Cmid) * 0.1, rng.randn(Cmid, Cout) * 0.1,
            rng.randn(Cout) * 0.1]
    args = [a.astype(np.float32) for a in args]
    for dtype in ("f32", "bf16"):
        jargs, pargs = _as(args, dtype, (2, 4, 6, 8))
        got = BP.fused_proj_bottleneck(*pargs, stride=stride)
        assert got.shape == (H // stride, W // stride, Cout)
        kernel = np.asarray(jax.jit(lambda *a: j_proj(
            *a, stride=stride, interpret=True))(*jargs), np.float32)
        ref = np.asarray(j_proj_ref(*jargs, stride=stride), np.float32)
        rel = 1e-4 if dtype == "f32" else 1e-2      # one bf16 step (3.9e-3)
        _close(n(got), kernel, rel)
        _close(n(got), ref, rel)


def test_proj_refuses_odd_sizes_and_gradients():
    rng = np.random.RandomState(5)
    args = [t(a.astype(np.float32)) for a in (
        rng.randn(7, 16, 32), rng.randn(32, 64), rng.randn(64),
        rng.randn(32, 16), rng.randn(16), rng.randn(144, 16), rng.randn(16),
        rng.randn(16, 64), rng.randn(64))]
    with pytest.raises(ValueError, match="stride-divisible"):
        BP.fused_proj_bottleneck(*args, stride=2)
    ok = [args[0][:6]] + args[1:]
    BP.fused_proj_bottleneck(*ok, stride=2)
    ok[3] = ok[3].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        BP.fused_proj_bottleneck(*ok, stride=2)
    with torch.no_grad():
        BP.fused_proj_bottleneck(*ok, stride=2)


def test_stack_gradient_matches_jax_custom_vjp():
    """The port's backward (autograd of the plain version, the rule of the
    kernel's autograd.Function) against the backward of the JAX kernel's
    custom_vjp, which is jax.vjp of its reference (res4.py:145-147), f32,
    every input."""
    rng = np.random.RandomState(2)
    args = _stack_args(rng, H=6, W=10, C=32, Cmid=16, B=2)
    g = rng.randn(6, 10, 32).astype(np.float32)
    want = jax.jit(lambda *a: jax.vjp(j_stack_ref, *a)[1](jnp.asarray(g)))(
        *[jnp.asarray(a) for a in args])

    def port_grads(fn):
        ins = [t(a).requires_grad_(True) for a in args]
        torch.autograd.backward(fn(*ins), t(g))
        return [x.grad for x in ins]
    # the CPU path, and the card's autograd.Function with its launch
    # swapped for the plain version
    launch = RS._launch
    try:
        RS._launch = RS.bottleneck_stack_reference
        via_function = port_grads(RS._Stack.apply)
    finally:
        RS._launch = launch
    for grads in (port_grads(RS.fused_bottleneck_stack), via_function):
        for got, ref in zip(grads, want):
            _close(n(got), np.asarray(ref))


# --------------------------------------------------------------------------
# the full-depth trunk: one flagship model, BN statistics jittered
# --------------------------------------------------------------------------

def _jitter_bn(model, seed):
    """Non-trivial frozen-BN statistics (identity BN would hide a fold bug)."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            leaf = name.rsplit(".", 1)[-1]
            shape = tuple(buf.shape)
            if leaf == "moving_var":
                buf.mul_(t(rng.uniform(0.5, 2.0, shape).astype(np.float32)))
            elif leaf in ("moving_mean", "beta"):
                buf.add_(t((rng.randn(*shape) * 0.1).astype(np.float32)))
            elif leaf == "gamma":
                buf.mul_(t(rng.uniform(0.8, 1.2, shape).astype(np.float32)))
    return model


@pytest.fixture(scope="module")
def flagship():
    """(cfg, port model, JAX params): the flagship at full depth and width,
    f32 trunk and head, tiny proposal counts, weights from init_params with
    jittered BN carried into a JAX parameter tree."""
    cfg = family_cfg("flagship", tiny_shapes=True)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.HEAD_DTYPE = "float32"
    model = _jitter_bn(init_params(build_model(cfg, device="cpu"), seed=3), 4)
    flat = to_jax_params(model.state_dict())
    params = unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                             for k, v in flat.items()})
    return cfg, model, params


_J_FOLDS = {}


def j_folds(params, dtype):
    """relation_tpu's fold_trunk_params of the flagship's c4, jitted and kept
    per dtype (eager, the fold takes seconds). Its [4]["stack"] is, by
    definition, relation_tpu's fold_res4_params."""
    if dtype not in _J_FOLDS:
        _J_FOLDS[dtype] = jax.jit(j_fold_trunk, static_argnums=1)(
            params["c4"], dtype)
    return _J_FOLDS[dtype]


def _image(size=(64, 64), seed=7):
    img = (np.random.RandomState(seed).randn(*size, 3) * 40).astype(np.float32)
    return np.asarray(j_s2d(img))


def _bf16_trunk(c4):
    """A bf16 copy of a trunk, convs computing in bf16 (build_model's
    policy)."""
    tc4 = ResNet101C4(dtype=torch.bfloat16)
    tc4.load_state_dict(c4.state_dict())
    for m in tc4.modules():
        if isinstance(m, Conv2d):
            m.compute_dtype = torch.bfloat16
    return tc4.eval()


def _unpad(fold, mid):
    """A JAX tower fold (wa, b1, w3, b2, wc, b3), Cmid padded, cut to mid;
    a leading block axis is kept."""
    wa, b1, w3, b2, wc, b3 = (np.asarray(a, np.float32) for a in fold)
    m = wa.shape[-1]
    w3 = w3.reshape(w3.shape[:-2] + (9, m, m))[..., :mid, :mid]
    return (wa[..., :mid], b1[..., :mid],
            w3.reshape(w3.shape[:-3] + (9 * mid, mid)), b2[..., :mid],
            wc[..., :mid, :], b3)


def test_folds_match_jax(flagship):
    _, model, params = flagship
    got = fold_trunk_params(model.c4, torch.float32)
    want = j_folds(params, jnp.float32)
    for stage, mid in ((2, 64), (3, 128), (4, 256)):
        w1, b1p = (np.asarray(a) for a in want[stage]["proj"][:2])
        jp = (w1, b1p) + _unpad(want[stage]["proj"][2:], mid)
        for g, w in zip(got[stage]["proj"], jp):
            assert g.dtype == torch.float32
            _close(n(g), w, 1e-6)
        for g, w in zip(got[stage]["stack"], _unpad(want[stage]["stack"], mid)):
            _close(n(g), w, 1e-6)
    res4 = fold_res4_params(model.c4, torch.float32)
    for g, w in zip(res4, got[4]["stack"]):
        assert torch.equal(g, w)
    assert not any(x.requires_grad for x in res4)
    b16 = fold_res4_params(model.c4)
    assert [x.dtype for x in b16] == [torch.bfloat16, torch.float32] * 3


def test_padded_jax_fold_gives_the_same_output(flagship):
    """res2 through the port's kernel functions on JAX's fold (Cmid padded
    64 -> 128 for the TPU's lane tile) and on the port's unpadded one."""
    _, model, params = flagship
    rng = np.random.RandomState(8)
    x = np.maximum(rng.randn(16, 16, 64), 0).astype(np.float32)
    want = j_folds(params, jnp.float32)[2]
    assert want["proj"][2].shape == (64, 128)
    got = fold_trunk_params(model.c4, torch.float32)[2]

    def run(f):
        y = BP.fused_proj_bottleneck(t(x), *[t(np.asarray(a)) for a in f["proj"]])
        return RS.fused_bottleneck_stack(y, *[t(np.asarray(a)) for a in f["stack"]])
    _close(n(run({k: [n(a) for a in v] for k, v in got.items()})),
           n(run(want)), 1e-5)


@pytest.mark.parametrize("form", ["res4_folded", "fuse_res4", "trunk_folded"])
def test_full_depth_trunk_matches_jax(flagship, form):
    _, model, params = flagship
    x = _image()
    P = {"params": params["c4"]}
    jc4 = JC4(dtype=jnp.float32, fuse_res4=True if form == "fuse_res4" else None)
    c4 = model.c4
    with torch.inference_mode():
        conv = c4(t(x)[None])
        if form == "res4_folded":
            got = c4(t(x)[None], fold_res4_params(c4, torch.float32))
            want = jc4.apply(P, jnp.asarray(x)[None],
                             j_folds(params, jnp.float32)[4]["stack"])
        elif form == "fuse_res4":
            c4.fuse_res4 = True
            try:
                got = c4(t(x)[None])
            finally:
                c4.fuse_res4 = None
            want = jc4.apply(P, jnp.asarray(x)[None])
        else:
            got = c4(t(x)[None], None, fold_trunk_params(c4, torch.float32))
            want = jc4.apply(P, jnp.asarray(x)[None], None,
                             j_folds(params, jnp.float32))
    assert got.shape == (1, 1024, 4, 4)
    _close(n(got.permute(0, 2, 3, 1)), np.asarray(want))
    _close(n(got), n(conv))


def test_full_depth_bf16_trunk_bands(flagship):
    """bf16 trunk, bf16 folds: the port's all-kernel trunk against JAX's
    (measured: 2.1e-2 of the largest element, correlation 0.99989), and both
    fused forms against the port's conv path (the JAX package's band,
    correlation > 0.999; measured 1.3e-2 and 1.6e-2, 0.99986 and 0.99982)."""
    _, model, params = flagship
    x = _image(seed=9)
    c4 = _bf16_trunk(model.c4)
    with torch.inference_mode():
        conv = n(c4(t(x)[None]))
        res4 = n(c4(t(x)[None], fold_res4_params(c4)))
        trunk = n(c4(t(x)[None], None, fold_trunk_params(c4)))
    want = np.asarray(JC4().apply({"params": params["c4"]}, jnp.asarray(x)[None],
                                  None, j_folds(params, BF16)), np.float32)
    got = trunk.transpose(0, 2, 3, 1)
    _close(got, want, 4e-2)
    assert _corr(got, want) > 0.9995
    for got in (res4, trunk):
        _close(got, conv, 0.1)
        assert _corr(got, conv) > 0.999


def test_conv_path_for_batches_and_odd_maps(flagship, monkeypatch):
    """B == 2 takes the conv path whatever is passed; a stem output with a
    dim not divisible by 4 drops trunk_folded (the stack still runs for
    res4_folded, as in JAX)."""
    _, model, _ = flagship
    c4 = model.c4
    calls = []

    def spy(name, fn):
        def call(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        monkeypatch.setattr(bb, name, call)
    spy("fused_bottleneck_stack", bb.fused_bottleneck_stack)
    spy("fused_proj_bottleneck", bb.fused_proj_bottleneck)
    trunk = fold_trunk_params(c4, torch.float32)
    res4 = fold_res4_params(c4, torch.float32)
    two = t(np.stack([_image(seed=1), _image(seed=2)]))
    odd = t(_image(size=(72, 64), seed=3))[None]               # stem 18 x 16
    with torch.inference_mode():
        for x in (two, odd):
            conv = c4(x)
            if x is two:
                assert torch.equal(c4(x, res4, trunk), conv)
                c4.fuse_res4 = True
                try:
                    assert torch.equal(c4(x), conv)
                finally:
                    c4.fuse_res4 = None
            assert torch.equal(c4(x, None, trunk), conv)
        assert calls == []
        c4.fuse_res4 = False
        try:
            assert torch.equal(c4(odd, res4), c4(odd))
        finally:
            c4.fuse_res4 = None
        assert calls == []
        _close(n(c4(odd, res4)), n(c4(odd)))
    assert calls == ["fused_bottleneck_stack"]


def test_predict_with_res4_folded_matches_jax(flagship):
    """The flagship's predict with the folded res4 stack against the JAX
    make_predict_fn given fold_res4_params(params["c4"]) (its Pallas
    kernels in interpret mode), and against the port's conv path."""
    from relation_tpu.core.predictor import make_predict_fn as j_make_predict
    from relation_tpu.core.trainer import build_model as j_build_model
    cfg, model, params = flagship
    x = _image(seed=11)
    im_info = np.asarray([64.0, 64.0, 1.0], np.float32)
    folded = prepare_res4_folded(model, enabled=True)
    assert folded[0].dtype == torch.float32
    predict = make_predict_fn(model, cfg)
    out = predict(t(x), t(im_info), folded)
    conv = predict(t(x), t(im_info))
    want = j_make_predict(j_build_model(cfg), cfg, (4, 4))(
        params, jnp.asarray(x), jnp.asarray(im_info),
        j_folds(params, jnp.float32)[4]["stack"])
    got = n(out["dets"])
    assert (got[:, 0] >= 0).sum() > 10
    np.testing.assert_allclose(n(out["rois"]), np.asarray(want["rois"]),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(got[:, 0], np.asarray(want["dets"])[:, 0])
    np.testing.assert_allclose(got[:, 1:], np.asarray(want["dets"])[:, 1:],
                               rtol=1e-4, atol=1e-3)
    _close(n(out["feat"]), n(conv["feat"]))


def test_prepare_res4_folded_keeps_and_renews_the_folds(flagship):
    cfg, model, _ = flagship
    assert prepare_res4_folded(model) is None
    tiny = build_model(family_cfg("flagship", tiny_shapes=True), tiny=True,
                       device="cpu")
    assert prepare_res4_folded(tiny, enabled=True) is None
    first = prepare_res4_folded(model, enabled=True)
    assert prepare_res4_folded(model, enabled=True) is first
    bn = model.c4.units(4)[5].bn4b5_branch2b
    with torch.no_grad():
        bn.moving_var.mul_(2.0)
    try:
        again = prepare_res4_folded(model, enabled=True)
        assert again is not first
        assert not torch.equal(again[2][4], first[2][4])         # res4b5
        assert torch.equal(again[2][3], first[2][3])
    finally:
        with torch.no_grad():
            bn.moving_var.div_(2.0)


def test_entry_serves_through_the_stack_when_fuse_res4_is_set(monkeypatch):
    """entry() with TPU.FUSE_RES4 runs res4b1..b22 as one stack call on the
    bf16 folds kept with the model, and answers as predict does given
    them."""
    from relation_tpu_torch import entry as E
    seen = []
    stack = bb.fused_bottleneck_stack

    def spy(x, *w):
        seen.append(w[0].shape)
        return stack(x, *w)
    monkeypatch.setattr(bb, "fused_bottleneck_stack", spy)
    cfg = family_cfg("flagship", tiny_shapes=True)
    cfg.TPU.FUSE_RES4 = True
    predict, (image, im_info) = E.entry(device="cpu", cfg=cfg)
    assert image.shape == (12, 304, 512)
    x = t(_image(seed=12))
    info = t(np.asarray([64.0, 64.0, 1.0], np.float32))
    out = predict(x, info)
    assert seen == [(22, 1024, 256)]
    assert out["dets"].shape == (100, 6)
    folded = prepare_res4_folded(predict.model, enabled=True)
    assert folded[0].dtype == torch.bfloat16
    ref = make_predict_fn(predict.model, cfg)(x, info, folded)
    assert torch.equal(out["dets"], ref["dets"])
