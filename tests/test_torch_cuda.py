"""The port's CUDA kernels against their plain versions on the card, at small
and ragged shapes and with the options the flagship does not use
(chip_smoke.py holds them at the flagship's shapes), gradients included. Marked ``cuda`` and
skipped where there is no card: a CUDA kernel has no CPU mode. The card's
machine has no JAX, so run this file without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from relation_tpu_torch.models.backbone import conv1_w4
from relation_tpu_torch.ops.embeddings import extract_multi_position_matrix_t
from relation_tpu_torch.ops.kernels import (geom_bias as GB, nms_attention as NA,
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
