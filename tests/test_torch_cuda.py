"""The port's CUDA kernels against their plain versions on the card, at small
and ragged shapes and with the options the flagship does not use
(chip_smoke.py holds them at the shapes of the driven models), gradients
included. Marked ``cuda`` and skipped where there is no card: a CUDA kernel
has no CPU mode. The card's machine has no JAX, so run this file without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from relation_tpu_torch.models.backbone import conv1_w4
from relation_tpu_torch.ops.embeddings import extract_multi_position_matrix_t
from relation_tpu_torch.ops.kernels import (dconv_col2im as DC, geom_bias as GB,
                                            nms_attention as NA,
                                            nms_kernel as NK, stem as ST)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _tens(x, dev):
    return torch.tensor(np.asarray(x, np.float32), device=dev)


def _boxes(rng, n, C, integer=False):
    """[n, C, 4] clustered boxes; integer corners make exact IoU ties."""
    centers = rng.uniform(30, 300, (C, 6, 2))
    cxy = centers[np.arange(C)[None, :], rng.randint(0, 6, (n, C))]
    cxy = cxy + rng.uniform(-10, 10, (n, C, 2))
    wh = rng.uniform(10, 60, (n, C, 2))
    b = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1)
    return np.round(b) if integer else b


@pytest.mark.parametrize("G", [4, 8, 16, 32])
def test_geom_bias_kernel_matches_plain(dev, G):
    rng = np.random.RandomState(G)
    C, N, M = 3, 37, 53
    pos = _tens(rng.randn(C, 4, N, M) * 2.0, dev)
    w, b = _tens(rng.randn(64, G) * 0.1, dev), _tens(rng.randn(G) * 0.05, dev)
    before = GB.launches
    got = GB.fused_geometric_bias(pos, w, b)
    assert GB.launches == before + 1
    want = GB.geom_bias_reference(pos, w, b)
    # the acc domain, and the log where acc is clear of the 1e-6 clamp
    assert float((got.exp() - want.exp()).abs().max()) <= 1e-5
    clear = want.exp() > 1e-2
    assert float((got - want)[clear].abs().max()) <= 1e-4


@pytest.mark.parametrize("thresh", [0.3, 0.7])
@pytest.mark.parametrize("max_keep", [None, 7, 100])
@pytest.mark.parametrize("block", [64, 256])
@pytest.mark.parametrize("integer", [False, True])
def test_nms_kernel_matches_plain_exactly(dev, thresh, max_keep, block, integer):
    rng = np.random.RandomState(int(thresh * 10) + block + (max_keep or 0))
    C, n, Np = 3, 500, 512
    bT = np.zeros((C, 4, Np), np.float32)
    bT[:, :, :n] = _boxes(rng, n, C, integer).transpose(1, 2, 0)
    valid = np.zeros((C, Np), np.float32)
    valid[:, :n] = rng.uniform(0, 1, (C, n)) > 0.1
    bT_t, v_t = _tens(bT, dev), _tens(valid, dev)
    before = NK.launches
    got = NK.nms_keep_sorted(bT_t, v_t, thresh, block=block, max_keep=max_keep)
    assert NK.launches == before + 1
    want = NK.nms_keep_sorted_reference(bT_t, v_t, thresh, block, max_keep)
    assert torch.equal(got, want)
    assert float(want.sum()) > 0


@pytest.mark.parametrize("B,Ho,Wo", [(2, 37, 45), (1, 3, 5), (1, 64, 130)])
def test_stem_kernel_matches_plain(dev, B, Ho, Wo):
    rng = np.random.RandomState(Ho)
    s2d = _tens(rng.randn(B, 12, Ho, Wo) * 40, dev)
    w4 = conv1_w4(_tens(rng.randn(64, 3, 7, 7) * (1 / 147) ** 0.5, dev))
    scale = _tens(rng.uniform(0.5, 2, 64), dev)
    bias = _tens(rng.randn(64), dev)
    before = ST.launches
    got = ST.stem_conv1_bn_relu(s2d, w4, scale, bias)
    assert ST.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (B, 64, Ho, Wo)
    want = ST.stem_reference(s2d, w4, scale, bias).float()
    # one bf16 ulp: both sum exact bf16 products in f32, in other orders
    diff = (got.float() - want).abs()
    assert bool((diff <= want.abs() * 2.0 ** -7 + 1e-4).all())


@pytest.mark.parametrize("N,G,D,F,E", [(8, 16, 64, 128, 8), (37, 16, 64, 128, 8),
                                       (100, 4, 32, 64, 16), (21, 6, 16, 32, 4),
                                       (13, 1, 16, 16, 8)])
def test_skip_attention_kernel_matches_plain(dev, N, G, D, F, E):
    """Cluster sizes 8, 4, 2 and 1 (the largest of them dividing G), ragged
    N; inactive classes are left unwritten, so only active rows compare."""
    rng = np.random.RandomState(N + G)
    C = 5
    pos = extract_multi_position_matrix_t(_tens(_boxes(rng, N, C), dev))
    q, k = (_tens(rng.randn(C, N, G * D) * 0.5, dev) for _ in range(2))
    v = _tens(rng.randn(C, N, F), dev)
    wg, bg = _tens(rng.randn(64, G) * 0.1, dev), _tens(rng.randn(G) * 0.05, dev)
    wl = _tens(rng.randn(G, F, E) * 0.1, dev)
    active = torch.tensor([1, 0, 1, 1, 0], dtype=torch.int32, device=dev)
    args = (pos.contiguous(), q, k, v, wg, bg, wl, active)
    before = NA.launches
    got = NA.fused_nms_relation_attention_skip(*args)
    assert NA.launches == before + 1
    want = NA.nms_relation_attention_reference(*args)
    on = active.bool()
    tol = 1e-4 * max(1.0, float(want[on].abs().max()))
    assert float((got[on] - want[on]).abs().max()) <= tol


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    pos = torch.zeros((1, 4, 8, 8), dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        GB.fused_geometric_bias(pos, torch.zeros((64, 16), device=dev),
                                torch.zeros(16, device=dev))
    with pytest.raises(ValueError):
        NK.nms_keep_sorted(torch.zeros((1, 4, 100), device=dev),
                           torch.zeros((1, 100), device=dev), 0.5, block=64)
    with pytest.raises(ValueError):
        ST.stem_conv1_bn_relu(torch.zeros((1, 3, 8, 8), device=dev),
                              torch.zeros((192, 64), device=dev),
                              torch.ones(64, device=dev), torch.zeros(64, device=dev))


# --------------------------------------------------------------------------
# the training path: geometric-bias backward, fused attention, gradients
# --------------------------------------------------------------------------

def _bwd_case(rng, C, N, M, G, dev, b_shift=0.0):
    pos = _tens(rng.randn(C, 4, N, M) * 2.0, dev)
    w = _tens(rng.randn(64, G) * 0.1, dev)
    b = _tens(rng.randn(G) * 0.05 + b_shift, dev)
    # cotangent zero close to the clamp, where 1/acc amplifies the last bit
    # of acc beyond any band (chip_smoke.py does the same)
    acc = GB.geom_acc_reference(pos, w, b)
    gout = _tens(rng.randn(C, G, N, M), dev) * ((acc > 2e-2) | (acc < -1e-3))
    return pos, w, b, gout


@pytest.mark.parametrize("G", [4, 8, 16, 32])
@pytest.mark.parametrize("C,N,M", [(1, 37, 53), (80, 9, 11), (3, 1, 1)])
def test_geom_bias_bwd_kernel_matches_plain(dev, G, C, N, M):
    """Ragged shapes (N*M no multiple of the 128-pair tile, fewer pairs than
    one tile), C = 1 and 80, every supported G: d_pos, d_W, d_b within 1e-4
    of their maxima, and bit-equal from run to run."""
    rng = np.random.RandomState(G + C + N)
    pos, w, b, gout = _bwd_case(rng, C, N, M, G, dev)
    got = GB._launch_bwd(pos, w, b, gout, 100.0)
    again = GB._launch_bwd(pos, w, b, gout, 100.0)
    want = GB.geom_bias_bwd_reference(pos, w, b, gout)
    for name, x, y, z in zip(("d_pos", "d_W", "d_b"), got, want, again):
        assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max()) + 1e-12, name
        assert torch.equal(x, z), name
    d_pos, d_w, d_b = GB._launch_bwd(pos, w, b, gout, 100.0, need_pos=False)
    assert d_pos is None and torch.equal(d_w, got[1]) and torch.equal(d_b, got[2])


@pytest.mark.parametrize("G", [4, 16, 32])
def test_geom_bias_bwd_clamp_decisions_are_the_forwards(dev, G):
    """b is moved so that pair 0 of class 0 sits on the 1e-6 clamp in every
    head (and many diagonal pairs with it): the backward's acc equals the
    forward's bit for bit on every element, clamped elements get exactly
    zero d_acc (seen through d_b with a cotangent of ones on one head), and
    a head clamped everywhere gets exactly zero d_W and d_b."""
    rng = np.random.RandomState(G)
    C, N = 5, 37
    pos = extract_multi_position_matrix_t(_tens(_boxes(rng, N, C), dev)).contiguous()
    w = _tens(rng.randn(64, G) * 0.1, dev)
    b = _tens(rng.randn(G) * 0.05, dev)
    b = (b + 1e-6 - GB.geom_acc_reference(pos, w, b)[0, :, 0, 0]).contiguous()
    ones = torch.ones((C, G, N, N), device=dev)
    acc_fwd = GB._launch(pos, w, b, 100.0, raw=True)
    _, d_w, d_b, acc_bwd = GB._launch_bwd(pos, w, b, ones, 100.0, need_pos=False,
                                          want_acc=True)
    assert torch.equal(acc_fwd, acc_bwd)
    assert int(((acc_fwd - 1e-6).abs() < 1e-6).sum()) >= G
    want_b = torch.where(acc_fwd > 1e-6, 1.0 / acc_fwd.double(), 0.0).sum((0, 2, 3))
    assert float(((d_b.double() - want_b).abs() / want_b.abs().clamp_min(1)).max()) < 1e-3
    b2 = b.clone()
    b2[0] = -50.0
    _, d_w, d_b = GB._launch_bwd(pos, w, b2, ones, 100.0, need_pos=False)
    assert not d_w[:, 0].any() and float(d_b[0]) == 0.0 and d_w[:, 1].any()


def test_geom_bias_gradient_through_autograd(dev):
    """The public function on the card: forward and backward kernels through
    autograd, a non-contiguous cotangent (the head permutes the bias) and a
    transposed weight view; against autograd of the plain version, and a
    finite-difference spot check in f32 on a clamp-free case (b = 1, small
    W; band 2e-2 of the directional derivative)."""
    rng = np.random.RandomState(3)
    C, N, M, G = 2, 19, 16, 16
    pos = _tens(rng.randn(C, 4, N, M) * 0.02, dev)
    wt = _tens(rng.randn(G, 64) * 0.02, dev).requires_grad_(True)
    b = _tens(rng.randn(G) * 0.05 + 1.0, dev).requires_grad_(True)
    pos.requires_grad_(True)
    cot = _tens(rng.randn(C, N, G, M), dev)

    def loss(fn, p, k, bb):
        return (fn(p, k.t(), bb).permute(0, 2, 1, 3) * cot).sum()
    f0, b0 = GB.launches, GB.bwd_launches
    got = torch.autograd.grad(loss(GB.fused_geometric_bias, pos, wt, b), [pos, wt, b])
    assert (GB.launches, GB.bwd_launches) == (f0 + 1, b0 + 1)
    want = torch.autograd.grad(loss(GB.geom_bias_reference, pos, wt, b), [pos, wt, b])
    for x, y in zip(got, want):
        assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max())
    # no gradient for pos asked: d_pos is not computed, W and b still are
    got2 = torch.autograd.grad(loss(GB.fused_geometric_bias, pos.detach(), wt, b),
                               [wt, b])
    assert torch.equal(got2[0], got[1]) and torch.equal(got2[1], got[2])
    with torch.no_grad():
        for x, g, eps in ((wt, got[1], 1e-2), (b, got[2], 1e-2), (pos, got[0], 1e-4)):
            d = _tens(rng.randn(*x.shape), dev)
            d = d / d.norm()
            up = loss(GB.fused_geometric_bias, *(v + eps * d if v is x else v
                                                 for v in (pos, wt, b)))
            dn = loss(GB.fused_geometric_bias, *(v - eps * d if v is x else v
                                                 for v in (pos, wt, b)))
            fd = float((up.double() - dn.double()) / (2 * eps))
            an = float((g * d).sum())
            assert abs(fd - an) <= 2e-2 * abs(an) + 1e-3, (fd, an)


@pytest.mark.parametrize("C", [1, 80])
@pytest.mark.parametrize("N", [16, 37, 100])
def test_full_attention_kernel_matches_plain(dev, C, N):
    """Every class computed (no active mask): forward within 1e-4 relative of
    the plain version; the gradients of q, v and the three weights equal
    autograd of the plain version (they are computed by it)."""
    rng = np.random.RandomState(C + N)
    G, D, F, E = 16, 64, 128, 8
    pos = extract_multi_position_matrix_t(_tens(_boxes(rng, N, C), dev)).contiguous()
    q, k = (_tens(rng.randn(C, N, G * D) * 0.5, dev) for _ in range(2))
    v = _tens(rng.randn(C, N, F), dev)
    wg, bg = _tens(rng.randn(64, G) * 0.1, dev), _tens(rng.randn(G) * 0.05 + 1.0, dev)
    wl = _tens(rng.randn(G, F, E) * 0.1, dev)
    args = [pos, q, k, v, wg, bg, wl]
    before = NA.full_launches
    got = NA.fused_nms_relation_attention(*args)
    assert NA.full_launches == before + 1
    want = NA.nms_relation_attention_reference(*args)
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol
    leaves = [a.clone().requires_grad_(i in (1, 3, 4, 5, 6))
              for i, a in enumerate(args)]
    wanted = [leaves[i] for i in (1, 3, 4, 5, 6)]
    cot = _tens(rng.randn(*want.shape), dev)
    g_kernel = torch.autograd.grad(NA.fused_nms_relation_attention(*leaves),
                                   wanted, cot)
    g_plain = torch.autograd.grad(NA.nms_relation_attention_reference(*leaves),
                                  wanted, cot)
    for x, y in zip(g_kernel, g_plain):
        assert float((x - y).abs().max()) <= 1e-5 * float(y.abs().max()) + 1e-9


def test_kernels_carry_a_gradient_or_refuse_one(dev):
    """On a CUDA tensor that requires a gradient no wrapper answers
    detached: the NMS mask and the skip attention raise, the stem carries
    the gradient of its plain version."""
    rng = np.random.RandomState(0)
    boxes = _tens(np.zeros((1, 4, 64)), dev).requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        NK.nms_keep_sorted(boxes, torch.ones((1, 64), device=dev), 0.5, block=64)
    with torch.no_grad():
        NK.nms_keep_sorted(boxes, torch.ones((1, 64), device=dev), 0.5, block=64)
    C, N, G, D, F, E = 2, 8, 16, 64, 128, 8
    pos = extract_multi_position_matrix_t(_tens(_boxes(rng, N, C), dev)).contiguous()
    q = _tens(rng.randn(C, N, G * D), dev).requires_grad_(True)
    rest = (_tens(rng.randn(C, N, G * D), dev), _tens(rng.randn(C, N, F), dev),
            _tens(rng.randn(64, G) * 0.1, dev), _tens(rng.randn(G), dev),
            _tens(rng.randn(G, F, E), dev),
            torch.ones(C, dtype=torch.int32, device=dev))
    with pytest.raises(RuntimeError, match="no backward"):
        NA.fused_nms_relation_attention_skip(pos, q, *rest)
    assert not NA.fused_nms_relation_attention_skip(pos, q.detach(), *rest).requires_grad
    s2d = _tens(rng.randn(1, 12, 9, 13) * 40, dev)
    w4 = conv1_w4(_tens(rng.randn(64, 3, 7, 7) * (1 / 147) ** 0.5, dev)) \
        .requires_grad_(True)
    scale, bias = _tens(rng.uniform(0.5, 2, 64), dev), _tens(rng.randn(64), dev)
    out = ST.stem_conv1_bn_relu(s2d, w4, scale, bias)
    assert out.requires_grad
    cot = _tens(rng.randn(*out.shape), dev)
    (g,) = torch.autograd.grad(out.float(), [w4], cot)
    (want,) = torch.autograd.grad(ST.stem_reference(s2d, w4, scale, bias).float(),
                                  [w4], cot)
    assert float((g - want).abs().max()) <= 1e-3 * float(want.abs().max())


def _col2im_case(rng, dev, B, H, W, G, cg, S, dtype):
    """Coordinates that leave the map on every side, with rows exactly on an
    integer, on -1, on H, on the last pixel, and a band inside (-1, 0)."""
    yy = rng.uniform(-2.5, H + 1.5, (B, S, G)).astype(np.float32)
    xx = rng.uniform(-2.5, W + 1.5, (B, S, G)).astype(np.float32)
    yy[:, 0::7] = np.round(yy[:, 0::7])
    xx[:, 1::7] = np.round(xx[:, 1::7])
    yy[:, 2::11], yy[:, 3::11] = -1.0, float(H)
    xx[:, 4::11], xx[:, 5::11] = -1.0, float(W)
    yy[:, 6::11], xx[:, 6::11] = H - 1.0, W - 1.0
    yy[:, 7::11], xx[:, 7::11] = -0.5, W - 0.25
    yy, xx = _tens(yy, dev), _tens(xx, dev)
    inside = (yy > -1.0) & (yy < H) & (xx > -1.0) & (xx < W)
    zero = torch.zeros_like(yy)
    d = _tens(rng.randn(B, S, G, cg), dev).to(dtype)
    return torch.where(inside, yy, zero), torch.where(inside, xx, zero), inside, d


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,G,cg,S", [
    (2, 5, 7, 4, 128, 9 * 35),        # H*W = 35, R = 315: neither a multiple
    (1, 6, 9, 2, 4, 301),             # cg 4: one 16-byte chunk a sample
    (3, 4, 5, 1, 3, 77),              # cg 3: the scalar path
    (1, 38, 64, 4, 128, 1000),        # the res5 map, few samples
])
def test_col2im_kernel_matches_plain(dev, dtype, B, H, W, G, cg, S):
    """1e-5 of the largest element (f32 sums in another order, by atomics on
    both sides); pixels out of every sample's reach exactly zero."""
    rng = np.random.RandomState(H * W + cg)
    yz, xz, inside, d = _col2im_case(rng, dev, B, H, W, G, cg, S, dtype)
    before = DC.launches
    got = DC.dconv_col2im(yz, xz, inside, d, H, W)
    assert DC.launches == before + 1
    want = DC.dconv_col2im_reference(yz, xz, inside, d, H, W)
    torch.cuda.synchronize()
    assert got.shape == (B, H, W, G * cg) and got.dtype == torch.float32
    top = float(want.abs().max())
    assert top > 0 and float((got - want).abs().max()) <= 1e-5 * top
    again = DC.dconv_col2im(yz, xz, inside, d, H, W)
    assert float((got - again).abs().max()) <= 1e-5 * top
    cover = DC.dconv_col2im_reference(yz, xz, inside, torch.ones_like(d[..., :1]),
                                      H, W)                      # [B, H, W, G]
    assert bool((got.view(B, H, W, G, cg)[cover == 0] == 0).all())
    none = DC.dconv_col2im(yz, xz, torch.zeros_like(inside), d, H, W)
    assert not bool(none.any())


def test_col2im_wrapper_refusals(dev):
    rng = np.random.RandomState(0)
    yz, xz, inside, d = _col2im_case(rng, dev, 1, 4, 4, 2, 4, 20, torch.float32)
    with pytest.raises(TypeError):
        DC.dconv_col2im(yz, xz, inside.float(), d, 4, 4)
    with pytest.raises(TypeError):
        DC.dconv_col2im(yz, xz, inside, d.half(), 4, 4)
    with pytest.raises(ValueError):
        DC.dconv_col2im(yz[:, :5], xz, inside, d, 4, 4)
    with pytest.raises(ValueError):
        DC.dconv_col2im(yz.transpose(1, 2).contiguous().transpose(1, 2), xz,
                        inside, d, 4, 4)
    with pytest.raises(RuntimeError, match="no backward"):
        DC.dconv_col2im(yz, xz, inside, d.clone().requires_grad_(True), 4, 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deformable_conv_backward_on_the_card(dev, dtype, monkeypatch):
    """The deformable conv's three gradients with dx from the kernel against
    the same backward with dx from the plain version, B=2, G=4, offsets that
    leave the map: dx within 1e-5 of its maximum in f32 (1e-2 in bf16: dx is
    rounded to bf16 once on each side), doffset and dw bit-equal (they do not
    run through the kernel); one launch a backward."""
    import relation_tpu_torch.ops.deform as D
    rng = np.random.RandomState(3)
    B, H, W, C, Co, G = 2, 9, 11, 16, 8, 4
    x = _tens(rng.randn(B, H, W, C), dev).to(dtype)
    w = _tens(rng.randn(3, 3, C, Co) * 0.1, dev).to(dtype)
    off = _tens(rng.randn(B, H, W, G * 18) * 2.5 + 0.3, dev)
    g = _tens(rng.randn(B, H, W, Co), dev).to(dtype)

    def grads():
        ins = [a.clone().requires_grad_(True) for a in (x, off, w)]
        out = D.deformable_conv_batched(*ins, kernel=3, dilation=2, num_groups=G)
        return torch.autograd.grad(out, ins, g)
    before = DC.launches
    got = grads()
    assert DC.launches == before + 1
    monkeypatch.setattr(D, "dconv_col2im", DC.dconv_col2im_reference)
    want = grads()
    assert DC.launches == before + 1
    top = float(want[0].float().abs().max())
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert float((got[0].float() - want[0].float()).abs().max()) <= tol * top
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert got[0].dtype == dtype and got[1].dtype == torch.float32


@pytest.mark.parametrize("max_keep", [None, 100])
def test_classwise_nms_on_the_card_equals_the_cpu(dev, max_keep):
    """The classic tail's shape: 80 classes of 300 boxes (Np 512), one kernel
    launch for all of them, keep masks equal to the CPU route bit for bit."""
    from relation_tpu_torch.ops.nms import classwise_nms
    rng = np.random.RandomState(5)
    C, n = 80, 300
    boxes = np.round(_boxes(rng, n, C)).transpose(1, 0, 2).astype(np.float32)
    scores = np.round(rng.uniform(0, 1, (C, n)), 2).astype(np.float32)
    valid = rng.uniform(0, 1, (C, n)) > 0.1
    before = NK.launches
    got = classwise_nms(_tens(boxes, dev), _tens(scores, dev), 0.3, 0.05,
                        torch.tensor(valid, device=dev), max_keep)
    assert NK.launches == before + 1
    want = classwise_nms(torch.tensor(boxes), torch.tensor(scores), 0.3, 0.05,
                         torch.tensor(valid), max_keep)
    assert torch.equal(got.cpu(), want) and bool(want.any())
