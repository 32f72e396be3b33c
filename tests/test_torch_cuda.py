"""The port's CUDA kernels against their plain versions on the card, at small
and ragged shapes and with the options the flagship does not use
(chip_smoke.py holds them at the shapes of the driven models), gradients
included. Marked ``cuda`` and skipped where there is no card: a CUDA kernel
has no CPU mode. The card's machine has no JAX, so run this file without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import ctypes

import numpy as np
import pytest
import torch

from relation_tpu_torch.models.backbone import conv1_w4
from relation_tpu_torch.ops.embeddings import extract_multi_position_matrix_t
from relation_tpu_torch.ops.kernels import (bias_attention as BA,
                                            bottleneck_proj as BP,
                                            dconv_col2im as DC, geom_bias as GB,
                                            nms_attention as NA,
                                            nms_kernel as NK, res4 as RS,
                                            roi_align as RA, roi_pool as RP,
                                            stem as ST)
from tests.test_torch_helpers import NMS_EDGE_CASES, nms_edge_case

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


@pytest.mark.parametrize("shape", ["proposals", "classic None", "classic 100"])
@pytest.mark.parametrize("kind", NMS_EDGE_CASES)
def test_nms_kernel_edge_cases(dev, kind, shape):
    """The cases a chunk-by-chunk walk can get wrong (tests/
    test_torch_helpers.py::nms_edge_case) at the proposals' shape (Np 6144,
    6000 boxes, max_keep 300; one class, or 2 and 4 where the case needs
    classes) and at the classic tail's (80 classes, Np 512, 300 boxes,
    max_keep None and 100): one launch, keep masks equal to the plain
    version's bit for bit, the launch tallied by shape."""
    if shape == "proposals":
        C = {"invalid_class": 2, "staggered_stops": 4}.get(kind, 1)
        Np, n, max_keep = 6144, 6000, 300
    else:
        C, Np, n = 80, 512, 300
        max_keep = None if shape == "classic None" else 100
    bT, valid, thresh = nms_edge_case(kind, C, Np, n, seed=Np + C)
    bT_t, v_t = _tens(bT, dev), _tens(valid, dev)
    before, shapes = NK.launches, dict(NK.launch_shapes)
    got = NK.nms_keep_sorted(bT_t, v_t, thresh, block=256, max_keep=max_keep)
    assert NK.launches == before + 1
    key = f"C={C} Np={Np}"
    assert NK.launch_shapes[key] == shapes.get(key, 0) + 1
    want = NK.nms_keep_sorted_reference(bT_t, v_t, thresh, 256, max_keep)
    assert torch.equal(got, want)
    assert float(want.sum()) > 0


@pytest.mark.parametrize("C", [1, 40, 100, 200])
def test_nms_kernel_cluster_sizes(dev, C):
    """The class count picks the cluster size (the largest of 8, 4, 2 whose
    C x size blocks the card holds at once, else 1). On an H100 (132 SMs,
    two blocks an SM) C = 1, 40, 100 and 200 take clusters of 8, 4, 2 and
    1: each gives the plain version's keep mask, on crowded classes whose
    walks stop in different chunks (one class visits 22 chunks)."""
    if C == 1:
        bT, valid, thresh = nms_edge_case("staggered_stops", 1, 6144, 6000, seed=3)
    else:
        bT, valid, thresh = nms_edge_case("staggered_stops", C, 2048, 2000, seed=C)
    bT_t, v_t = _tens(bT, dev), _tens(valid, dev)
    want = NK.nms_keep_sorted_reference(bT_t, v_t, thresh, 256, 300)
    if C == 1:
        assert int(torch.nonzero(want[0]).max()) >= 20 * 256
    assert torch.equal(NK.nms_keep_sorted(bT_t, v_t, thresh, 256, 300), want)


def test_nms_kernel_refuses_a_kept_list_over_capacity(dev):
    """A walk that could keep more boxes a class than the kernel's kept list
    holds (1024 a block, clusters of at most 8 blocks) is refused before the
    launch."""
    Np = 16 * 1024
    before = NK.launches
    with pytest.raises(ValueError, match="kept list"):
        NK.nms_keep_sorted(torch.zeros((1, 4, Np), device=dev),
                           torch.ones((1, Np), device=dev), 0.5, block=256)
    assert NK.launches == before


@pytest.mark.parametrize("B,Ho,Wo", [(2, 37, 45), (1, 3, 5), (1, 64, 130),
                                    (1, 304, 512)])
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
    # one bf16 ulp of the plain value
    diff = (got.float() - want).abs()
    assert bool((diff <= want.abs() * 2.0 ** -7 + 1e-4).all())
    # and bit for bit: the kernel recomputes exactly every output its
    # tensor-core sums could round differently (the flagship's 608x1024
    # image among the shapes)
    assert torch.equal(got.float(), want)


@pytest.mark.parametrize("N,G,D,F,E", [(8, 16, 64, 128, 8), (37, 16, 64, 128, 8),
                                       (100, 4, 32, 64, 16), (21, 6, 16, 32, 4),
                                       (13, 1, 16, 16, 8), (150, 16, 64, 128, 8),
                                       (129, 16, 64, 128, 8), (256, 8, 64, 128, 8)])
def test_skip_attention_kernel_matches_plain(dev, N, G, D, F, E):
    """Cluster sizes 8, 4, 2 and 1 (the largest of them dividing G), ragged
    N, and the row tiles of N > 128 (N=150: FIRST_N of the FPN learned-NMS
    head, 3 tiles of 52 rows; 129: a last tile of 41 rows); inactive classes
    are left unwritten, so only active rows compare."""
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
@pytest.mark.parametrize("C,N,M", [(1, 37, 53), (80, 9, 11), (3, 1, 1),
                                   (1, 316, 300), (2, 33, 31), (80, 100, 100),
                                   (5, 7, 9)])
def test_geom_bias_bwd_kernel_matches_plain(dev, G, C, N, M):
    """Ragged shapes (C*N*M no multiple of the 32-pair unit: 94,800 pairs at
    the head's 316x300, 2,046, 315; fewer pairs than one unit), C = 1 and
    80 (and the learned-NMS shape N=M=100), every supported G: d_pos, d_W,
    d_b within 1e-4 of their maxima, bit-equal from run to run, and a grid
    no larger than the units give work for."""
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
    fn = GB._build.load("geom_bias_bwd").geom_bias_bwd_blocks
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int, ctypes.c_long,
                                             ctypes.c_void_p]
    blocks = ctypes.c_int(0)
    assert fn(G, C * N * M, ctypes.byref(blocks)) == 0
    units = -(-(C * N * M) // 32)
    assert 1 <= blocks.value <= -(-units // 4)


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
    (1, 100, 64, 4, 128, 20000),      # a map taller than the res5 map
    (2, 3, 2000, 1, 8, 6000),         # a very wide map: many cells a (b, g)
])
def test_col2im_kernel_matches_plain(dev, dtype, B, H, W, G, cg, S):
    """1e-5 of the largest element (f32 sums in another order: the gather
    against index_add_); pixels out of every sample's reach exactly zero."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_col2im_kernel_on_crowded_cells(dev, dtype):
    """Most samples in a few cells (hundreds of samples a cell: the buckets
    full, the rest added by the spill pass) and the rest spread: within
    1e-5 of the largest element of the plain version; the pixels of no cell
    exactly zero."""
    rng = np.random.RandomState(17)
    B, H, W, G, cg, S = 2, 6, 9, 2, 12, 3000
    yz, xz, inside, d = _col2im_case(rng, dev, B, H, W, G, cg, S, dtype)
    crowd = torch.rand(B, S, G, device=dev) < 0.7
    yz = torch.where(crowd, 2.25 + 0.5 * torch.rand(B, S, G, device=dev), yz)
    xz = torch.where(crowd, 3.1 + 0.8 * torch.rand(B, S, G, device=dev), xz)
    inside = inside | crowd
    got = DC.dconv_col2im(yz, xz, inside, d, H, W)
    want = DC.dconv_col2im_reference(yz, xz, inside, d, H, W)
    torch.cuda.synchronize()
    top = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * top
    cover = DC.dconv_col2im_reference(yz, xz, inside, torch.ones_like(d[..., :1]),
                                      H, W)
    assert bool((got.view(B, H, W, G, cg)[cover == 0] == 0).all())


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


# --------------------------------------------------------------------------
# the fused trunk: identity-bottleneck stack and projection bottleneck
# --------------------------------------------------------------------------

def _tower(rng, C, Cmid, dev, lead=()):
    """(wa, b1, w3, b2, wc, b3) of folded bottlenecks: bf16 weights scaled
    so that a long stack keeps its activations in range, f32 biases."""
    def w(*shape, fan):
        return _tens(rng.randn(*lead, *shape) / np.sqrt(fan), dev).to(torch.bfloat16)
    def b(n):
        return _tens(rng.randn(*lead, n) * 0.1, dev)
    return (w(C, Cmid, fan=C), b(Cmid), w(9 * Cmid, Cmid, fan=9 * Cmid),
            b(Cmid), w(Cmid, C, fan=4 * Cmid), b(C))


def _map(rng, H, W, C, dev):
    return _tens(np.maximum(rng.randn(H, W, C), 0), dev).to(torch.bfloat16)


def _band(got, want):
    """(max abs error / max |want|, correlation) of two bf16 maps."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) / float(want.abs().max())
    corr = float(torch.corrcoef(torch.stack([got.flatten(),
                                             want.flatten()]))[0, 1])
    return err, corr


@pytest.mark.parametrize("H,W,C,Cmid,B", [(7, 9, 64, 64, 1), (13, 21, 256, 64, 2),
                                          (19, 33, 512, 128, 3),
                                          (10, 17, 1024, 256, 1),
                                          (11, 13, 256, 128, 22),
                                          # W around the 64-pixel TMA box
                                          (5, 63, 128, 64, 2), (3, 64, 256, 128, 2),
                                          (4, 65, 128, 64, 1), (2, 128, 256, 128, 2),
                                          (3, 256, 128, 64, 1),
                                          # H*W below one 64-pixel tile
                                          (3, 5, 64, 64, 2), (1, 1, 128, 128, 1)])
def test_bottleneck_stack_kernel_matches_plain(dev, H, W, C, Cmid, B):
    """Ragged maps (rows not a multiple of the 64-row tile), Cmid 64, 128 and
    256, B = 1 to 22. Both sum exact bf16 products in f32 in other orders
    and round y1, y2 and each block's output to bf16, so a few elements sit
    one bf16 step apart and the step travels through the later blocks: one
    block within 2^-7 of the largest element, 22 within 2e-2 and correlation
    0.9999."""
    rng = np.random.RandomState(H * W + B)
    x = _map(rng, H, W, C, dev)
    w = _tower(rng, C, Cmid, dev, (B,))
    x0 = x.clone()
    before = RS.launches
    got = RS.fused_bottleneck_stack(x, *w)
    assert RS.launches == before + 1
    assert torch.equal(x, x0), "the caller's map was written"
    assert got.dtype == torch.bfloat16 and got.shape == (H, W, C)
    want = RS.bottleneck_stack_reference(x, *w)
    err, corr = _band(got, want)
    assert bool(torch.isfinite(got.float()).all())
    assert err <= (2.0 ** -7 if B == 1 else 2e-2) and corr > 0.9999, (err, corr)


def test_bottleneck_stack_kernel_at_the_res4_shape(dev):
    """res4b1..b22 of the 608x1024 trunk: [38, 64, 1024], Cmid 256, B = 22,
    in the bands of the ragged cases."""
    rng = np.random.RandomState(4)
    x = _map(rng, 38, 64, 1024, dev)
    w = _tower(rng, 1024, 256, dev, (22,))
    got = RS.fused_bottleneck_stack(x, *w)
    err, corr = _band(got, RS.bottleneck_stack_reference(x, *w))
    assert bool(torch.isfinite(got.float()).all())
    assert err <= 2e-2 and corr > 0.9999, (err, corr)


@pytest.mark.parametrize("H,W,C,Cmid,B", [(9, 70, 256, 128, 3), (38, 64, 1024, 256, 2)])
def test_bottleneck_stack_kernel_in_place(dev, H, W, C, Cmid, B):
    """The C entry point with out aliasing x: block 0 reads each tile of x
    before its expand overwrites it, so the result is the out-of-place one,
    bit for bit."""
    from relation_tpu_torch.ops.kernels import _build
    rng = np.random.RandomState(H + B)
    x = _map(rng, H, W, C, dev)
    w = [t.contiguous() for t in _tower(rng, C, Cmid, dev, (B,))]
    want = RS.fused_bottleneck_stack(x, *w)
    y1 = torch.empty((H * W, Cmid), dtype=torch.bfloat16, device=dev)
    y2 = torch.empty_like(y1)
    fn = _build.load("bottleneck").bottleneck_stack
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    rc = fn(*[_build.ptr(t) for t in [x] + w + [x, y1, y2]], B, H, W, C, Cmid,
            _build.stream_ptr(dev))
    _build.check(rc, "bottleneck_stack")
    torch.cuda.synchronize()
    assert torch.equal(x, want)


@pytest.mark.parametrize("Hi,Wi,Cin,Cmid,Cout,stride", [
    (14, 18, 64, 64, 256, 1), (26, 34, 256, 128, 512, 2),
    (10, 22, 512, 256, 1024, 2), (7, 9, 128, 64, 128, 1),
    # output W of 63, 65 and 64 pixels, and a map below one tile
    (4, 126, 128, 64, 128, 2), (2, 130, 256, 128, 256, 2),
    (3, 64, 64, 64, 128, 1), (2, 6, 128, 64, 128, 2)])
def test_proj_bottleneck_kernel_matches_plain(dev, Hi, Wi, Cin, Cmid, Cout,
                                              stride):
    rng = np.random.RandomState(Hi * Wi + stride)
    x = _map(rng, Hi, Wi, Cin, dev)
    w1 = _tens(rng.randn(Cin, Cout) / np.sqrt(Cin), dev).to(torch.bfloat16)
    b1p = _tens(rng.randn(Cout) * 0.1, dev)
    tower = _tower(rng, Cin, Cmid, dev)[:4] + (
        _tens(rng.randn(Cmid, Cout) / np.sqrt(Cmid), dev).to(torch.bfloat16),
        _tens(rng.randn(Cout) * 0.1, dev))
    before = BP.launches
    got = BP.fused_proj_bottleneck(x, w1, b1p, *tower, stride=stride)
    assert BP.launches == before + 1
    assert got.shape == (Hi // stride, Wi // stride, Cout)
    want = BP.proj_bottleneck_reference(x, w1, b1p, *tower, stride=stride)
    err, corr = _band(got, want)
    assert err <= 2.0 ** -7 and corr > 0.9999, (err, corr)


def test_bottleneck_stack_gradient_and_refusals(dev):
    """The gradient through the kernel is autograd of the plain version on
    the same inputs; the wrappers refuse what the kernels do not take."""
    rng = np.random.RandomState(3)
    x = _map(rng, 9, 11, 128, dev)
    w = _tower(rng, 128, 64, dev, (2,))
    g = _tens(rng.randn(9, 11, 128), dev).to(torch.bfloat16)

    def grads(fn):
        ins = [t.clone().requires_grad_(True) for t in (x,) + w]
        return torch.autograd.grad(fn(*ins), ins, g)
    before = RS.launches
    got = grads(RS.fused_bottleneck_stack)
    assert RS.launches == before + 1
    want = grads(RS.bottleneck_stack_reference)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(TypeError):
        RS.fused_bottleneck_stack(x.float(), *w)
    with pytest.raises(ValueError):
        RS.fused_bottleneck_stack(_map(rng, 4, 4, 96, dev),
                                  *_tower(rng, 96, 64, dev, (1,)))
    with pytest.raises(RuntimeError, match="no backward"):
        BP.fused_proj_bottleneck(x.clone().requires_grad_(True),
                                 _tens(rng.randn(128, 128), dev).bfloat16(),
                                 _tens(rng.randn(128), dev), *_tower(rng, 128, 64, dev))


# --------------------------------------------------------------------------
# the two-stage learned-NMS attention of the FPN tail: skip geometric bias,
# bias attention with and without class skipping
# --------------------------------------------------------------------------

def _bias_attention_case(rng, dev, C, N, G=16, D=64, F=128, E=8):
    pos = extract_multi_position_matrix_t(_tens(_boxes(rng, N, C), dev)).contiguous()
    wg, bg = _tens(rng.randn(64, G) * 0.1, dev), _tens(rng.randn(G) * 0.05, dev)
    bias = GB.geom_bias_reference(pos, wg, bg)
    q, k = (_tens(rng.randn(C, N, G * D) * 0.5, dev) for _ in range(2))
    v = _tens(rng.randn(C, N, F), dev)
    wl = _tens(rng.randn(G, F, E) * 0.1, dev)
    return pos, wg, bg, bias, q, k, v, wl


@pytest.mark.parametrize("C,N,n_active", [(5, 37, 3), (80, 150, 16), (3, 1, 1),
                                          (7, 61, 0)])
def test_geom_bias_skip_kernel_matches_plain(dev, C, N, n_active):
    """Active rows bit-equal to the unskipped kernel's and in the bands of
    the unskipped kernel's test against the plain version; no active class
    launches a kernel that writes nothing."""
    rng = np.random.RandomState(C + N)
    pos, wg, bg, _, _, _, _, _ = _bias_attention_case(rng, dev, C, N)
    act = np.zeros(C, np.int32)
    act[rng.choice(C, n_active, replace=False)] = 1
    active = torch.tensor(act, device=dev)
    before = GB.skip_launches
    got = GB.fused_geometric_bias_skip(pos, wg, bg, active)
    assert GB.skip_launches == before + 1
    on = active.bool()
    assert torch.equal(got[on], GB.fused_geometric_bias(pos, wg, bg)[on])
    want = GB.geom_bias_skip_reference(pos, wg, bg, active)
    if n_active:
        assert float((got[on].exp() - want[on].exp()).abs().max()) <= 1e-5
        clear = want[on].exp() > 1e-2
        assert float((got[on] - want[on])[clear].abs().max()) <= 1e-4


@pytest.mark.parametrize("C,N,n_active", [(5, 37, 3), (80, 150, 16), (80, 150, 80),
                                          (3, 1, 2), (4, 65, 1), (2, 256, 2),
                                          (3, 130, 2), (3, 17, 2), (80, 100, 80),
                                          (4, 151, 3), (2, 200, 1), (1, 255, 1),
                                          (3, 305, 3), (2, 408, 2), (1, 412, 1)])
def test_bias_attention_kernels_match_plain(dev, C, N, n_active):
    """Both entry points at ragged N (no multiple of the 8-key n-tile or of
    the 16-row tile: 17, 37, 65, 130, 151 odd, 255), at the C4 tail's N=100
    and the FPN tail's N=150 with 16 of 80 classes and with all 80, and
    above one key chunk of 152 (N=200, 255, 256: two chunks and two blocks
    of query rows; 305: a last chunk of one key; 408, the largest N the
    earlier design took at these widths, and 412 beyond it: three chunks
    and three row blocks): active rows within 1e-4 of the largest element of
    the plain version, the unskipped kernel's rows equal to the skip
    kernel's on active classes (one kernel body), and bit-equal from run to
    run."""
    rng = np.random.RandomState(C * N + n_active)
    _, _, _, bias, q, k, v, wl = _bias_attention_case(rng, dev, C, N)
    act = np.zeros(C, np.int32)
    act[rng.choice(C, n_active, replace=False)] = 1
    active = torch.tensor(act, device=dev)
    s0, f0 = BA.skip_launches, BA.launches
    got = BA.fused_bias_attention_skip(bias, q, k, v, wl, active)
    full = BA.fused_bias_attention(bias, q, k, v, wl)
    assert (BA.skip_launches, BA.launches) == (s0 + 1, f0 + 1)
    want = BA.bias_attention_reference(bias, q, k, v, wl)
    on = active.bool()
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    assert float((full - want).abs().max()) <= tol
    assert float((got[on] - want[on]).abs().max()) <= tol
    assert torch.equal(got[on], full[on])
    assert torch.equal(BA.fused_bias_attention(bias, q, k, v, wl), full)


def test_bias_attention_gradient_and_refusals(dev):
    """Row 7 carries the gradient of autograd of its plain version (the JAX
    custom VJP's rule) for every input; row 8 and the skip geometric bias
    refuse an input that requires a gradient; a shape the kernels do not
    take is refused with a ValueError before any launch: for the bias
    attention D over 64 or no multiple of 8, and a value width whose u rows
    overflow the shared memory of a block (it takes any N); for the fused
    skip attention D no multiple of 4, and a q/k width whose rows overflow
    the shared memory of a block (it takes any N)."""
    rng = np.random.RandomState(5)
    C, N = 3, 29
    _, wg, bg, bias, q, k, v, wl = _bias_attention_case(rng, dev, C, N)
    leaves = [a.clone().requires_grad_(True) for a in (bias, q, k, v, wl)]
    cot = _tens(rng.randn(C, N, 16 * 8), dev)
    before = BA.launches
    g_kernel = torch.autograd.grad(BA.fused_bias_attention(*leaves), leaves, cot)
    assert BA.launches == before + 1
    g_plain = torch.autograd.grad(BA.bias_attention_reference(*leaves), leaves, cot)
    for x, y in zip(g_kernel, g_plain):
        assert float((x - y).abs().max()) <= 1e-5 * float(y.abs().max()) + 1e-9
    active = torch.ones(C, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        BA.fused_bias_attention_skip(leaves[0], q, k, v, wl, active)
    with pytest.raises(RuntimeError, match="no backward"):
        GB.fused_geometric_bias_skip(torch.zeros((C, 4, N, N), device=dev),
                                     wg.clone().requires_grad_(True), bg, active)
    assert NA.smem_bytes(150, 72, 8, 1, 128) <= NA.MAX_SMEM \
        < NA.smem_bytes(150, 256, 8, 1, 128)
    z = torch.zeros
    for D in (72, 60):      # over the kernel's 64 columns; no multiple of 8
        with pytest.raises(ValueError, match="D a multiple of 8 up to 64"):
            BA.fused_bias_attention(z((1, 16, N, N), device=dev),
                                    z((1, N, 16 * D), device=dev),
                                    z((1, N, 16 * D), device=dev),
                                    z((1, N, 128), device=dev),
                                    z((16, 128, 8), device=dev))
    with pytest.raises(ValueError, match="shared memory"):
        BA.fused_bias_attention(z((1, 2, 150, 150), device=dev),
                                z((1, 150, 128), device=dev),
                                z((1, 150, 128), device=dev),
                                z((1, 150, 128), device=dev),
                                z((2, 128, 512), device=dev))
    for D, match in ((6, "multiples of 4"), (256, "shared memory")):
        with pytest.raises(ValueError, match=match):
            NA.fused_nms_relation_attention_skip(
                z((1, 4, 150, 150), device=dev), z((1, 150, 16 * D), device=dev),
                z((1, 150, 16 * D), device=dev), z((1, 150, 128), device=dev),
                z((64, 16), device=dev), z(16, device=dev),
                z((16, 128, 8), device=dev),
                torch.ones(1, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("N", [45, 150])
def test_attention_kernels_take_values_wider_than_two_heads(dev, N):
    """F = 160 > 2 * D = 64 and E = 12 (the value width is free: the kernels
    project v through Wl before the attention): rows 6-9 within 1e-4 of the
    largest element of their plain versions, at one row tile and at three."""
    rng = np.random.RandomState(N)
    C, G, D, F, E = 4, 8, 32, 160, 12
    pos, wg, bg, bias, q, k, v, wl = _bias_attention_case(rng, dev, C, N, G, D, F, E)
    active = torch.tensor([1, 0, 1, 0], dtype=torch.int32, device=dev)
    on = active.bool()
    want = BA.bias_attention_reference(bias, q, k, v, wl)
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    pairs = [(BA.fused_bias_attention(bias, q, k, v, wl), slice(None)),
             (BA.fused_bias_attention_skip(bias, q, k, v, wl, active), on),
             (NA.fused_nms_relation_attention(pos, q, k, v, wg, bg, wl), slice(None)),
             (NA.fused_nms_relation_attention_skip(pos, q, k, v, wg, bg, wl, active), on)]
    for got, rows in pairs:
        assert float((got[rows] - want[rows]).abs().max()) <= tol


@pytest.mark.parametrize("C,N,G,D,F,E,n_active", [
    (80, 100, 16, 64, 128, 8, 16), (80, 150, 16, 64, 128, 8, 16),
    (3, 153, 16, 64, 128, 8, 2), (3, 408, 16, 64, 128, 8, 2),
    (2, 412, 16, 64, 128, 8, 1), (2, 500, 16, 64, 128, 8, 2),
    (4, 45, 8, 12, 16, 8, 2), (3, 70, 4, 72, 64, 8, 2), (5, 29, 32, 20, 36, 5, 3)])
def test_fused_attention_kernels_bit_equal_and_any_n(dev, C, N, G, D, F, E,
                                                     n_active):
    """Rows 6 and 9 at the flagship's N=100 and the FPN tail's N=150 (16 of
    80 classes), above one key chunk of 152 (153; 408, the largest N the
    earlier design took at these widths; 412 and 500 beyond it), at D no
    multiple of 8 (12, 20) or over 64 (72), with clusters of 8, 4 and 16
    heads (G=8, 4, 32): active rows within 1e-4 of the largest element of
    the plain version, the skip entry's active rows equal to the full
    entry's, and both bit-equal from run to run."""
    rng = np.random.RandomState(C * N + D)
    pos, wg, bg, _, q, k, v, wl = _bias_attention_case(rng, dev, C, N, G, D, F, E)
    act = np.zeros(C, np.int32)
    act[rng.choice(C, n_active, replace=False)] = 1
    active = torch.tensor(act, device=dev)
    args = (pos, q, k, v, wg, bg, wl)
    s0, f0 = NA.launches, NA.full_launches
    got = NA.fused_nms_relation_attention_skip(*args, active)
    full = NA.fused_nms_relation_attention(*args)
    assert (NA.launches, NA.full_launches) == (s0 + 1, f0 + 1)
    on = active.bool()
    want = NA.nms_relation_attention_reference(pos[on], q[on], k[on], v[on],
                                               wg, bg, wl)
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    assert float((got[on] - want).abs().max()) <= tol
    assert torch.equal(got[on], full[on])
    assert torch.equal(NA.fused_nms_relation_attention_skip(*args, active)[on],
                       got[on])
    assert torch.equal(NA.fused_nms_relation_attention(*args), full)


def _roi_case(rng, H, W, C, R, stride=16):
    """Clipped ROIs over a map of H x W cells, sides of 1 to W cells, some
    degenerate (sub-cell) ones among them."""
    x1 = rng.uniform(-10, W * stride, R)
    y1 = rng.uniform(-10, H * stride, R)
    wh = np.exp(rng.uniform(np.log(2.0), np.log(W * stride), (R, 2)))
    rois = np.stack([x1, y1, x1 + wh[:, 0], y1 + wh[:, 1]], 1)
    rois[:, 0::2] = rois[:, 0::2].clip(0, W * stride - 1)
    rois[:, 1::2] = rois[:, 1::2].clip(0, H * stride - 1)
    rois[: R // 8, 2:] = rois[: R // 8, :2] + 0.4
    return rois.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,W,C,R,P", [(38, 64, 256, 300, 7), (25, 40, 8, 33, 3),
                                       (7, 5, 3, 10, 7), (152, 256, 64, 40, 7)])
def test_roi_pool_kernel_matches_plain(dev, dtype, H, W, C, R, P):
    """Forward: values and argmax equal to the plain version's (maxima of the
    inputs, first maximum in scan order); one launch a call; under no_grad
    the forward without the argmax gives the same values. Backward, on
    the cotangent rounded to feat's dtype as the kernel receives it: the
    atomics' sums within 1e-5 of the largest element of the plain
    version's in f32 (the same terms in another order); in bf16, the
    kernel's f32 sums rounded once against the plain f32 gradient rounded
    to bf16, within one bf16 step."""
    rng = np.random.RandomState(H + C)
    dt = getattr(torch, dtype)
    feat = torch.tensor(rng.randn(H, W, C).astype(np.float32), device=dev).to(dt)
    rois = _tens(_roi_case(rng, H, W, C, R), dev)
    cot = torch.tensor(rng.randn(R, P, P, C).astype(np.float32), device=dev)
    before = (RP.launches, RP.bwd_launches)
    f = feat.clone().requires_grad_()
    got = RP.roi_pool(f, rois, 1.0 / 16, P)
    (got.float() * cot).sum().backward()
    torch.cuda.synchronize()
    assert (RP.launches, RP.bwd_launches) == (before[0] + 1, before[1] + 1)
    ref_f = feat.float().clone().requires_grad_()
    want = RP.roi_pool_reference(ref_f, rois, 1.0 / 16, P)
    # the kernel's cotangent arrives in feat's dtype: the same values here
    (want * cot.to(dt).float()).sum().backward()
    assert got.dtype == dt
    assert torch.equal(got.detach().float(), want.detach())
    am = RP.roi_pool_argmax_reference(feat, rois, 1.0 / 16, P)
    _, k_am = RP._launch(feat, rois, 1.0 / 16, P)
    assert torch.equal(k_am.long(), am)
    # inference: the forward without the argmax, one launch, the same values
    with torch.no_grad():
        again = RP.roi_pool(f, rois, 1.0 / 16, P)
    assert RP.launches == before[0] + 2
    assert torch.equal(again, got.detach())
    if dtype == "float32":
        top = float(ref_f.grad.abs().max())
        assert float((f.grad - ref_f.grad).abs().max()) <= 1e-5 * top
    else:
        g = ref_f.grad.to(dt).float()
        assert ((f.grad.float() - g).abs()
                <= g.abs() * 2.0 ** -7 + 1e-30).all()


def test_roi_pool_kernel_refuses_bad_inputs(dev):
    feat = torch.zeros(4, 4, 2, device=dev)
    rois = torch.zeros(3, 4, device=dev)
    with pytest.raises(ValueError):
        RP.roi_pool(feat[None], rois, 0.25)
    with pytest.raises(TypeError):
        RP.roi_pool(feat.to(torch.float16), rois, 0.25)
    with pytest.raises(ValueError):
        RP.roi_pool(feat, rois.cpu(), 0.25)


# the FPN cell's pyramid (an 800x1024 bucket, strides 4-32) and the C4
# head's map (38x64 at stride 16)
PYRAMIDS = {"fpn": ((200, 256), (100, 128), (50, 64), (25, 32)),
            "c4": ((38, 64),), "ragged": ((97, 125), (49, 63), (25, 32))}


def _pyramid_rois(rng, R, im_h, im_w, lo=16.0, hi=900.0):
    """R ROIs of sides lo to hi px inside an im_h x im_w image, so that a
    pyramid's every level gets some."""
    c = rng.uniform([0, 0], [im_w, im_h], (R, 2))
    wh = np.exp(rng.uniform(np.log(lo), np.log(hi), (R, 2)))
    b = np.concatenate([c - wh / 2, c + wh / 2], 1)
    b[:, 0::2] = b[:, 0::2].clip(0, im_w - 1)
    b[:, 1::2] = b[:, 1::2].clip(0, im_h - 1)
    return b.astype(np.float32)


def _pyramid_case(rng, dev, kind, C, R, dtype):
    shapes = PYRAMIDS[kind]
    strides = (16,) if kind == "c4" else (4, 8, 16, 32)[:len(shapes)]
    levels = [torch.tensor(rng.randn(h, w, C).astype(np.float32),
                           device=dev).to(dtype) for h, w in shapes]
    im_h, im_w = shapes[0][0] * strides[0], shapes[0][1] * strides[0]
    rois = _tens(_pyramid_rois(rng, R, im_h, im_w), dev)
    return levels, [1.0 / s for s in strides], rois


def _align_grads(levels, scales, rois, cot, fn):
    """(out, grads of every level) of ``fn`` under the cotangent ``cot``."""
    lv = [f.clone().requires_grad_() for f in levels]
    out = fn(lv, scales, rois)
    grads = torch.autograd.grad(out, lv, cot.to(out.dtype))
    return out.detach(), grads


@pytest.mark.parametrize("kind,C,R,dtype", [
    ("fpn", 256, 1016, "float32"), ("c4", 256, 300, "float32"),
    ("c4", 256, 300, "bfloat16"), ("ragged", 3, 37, "float32"),
    ("ragged", 12, 50, "bfloat16")])
def test_roi_align_kernel_matches_plain(dev, kind, C, R, dtype):
    """The pyramid ROIAlign kernel against its plain version, forward and
    backward, one launch of each a call. f32: the forward within 1e-5 of
    the largest output (the same 16 taps summed in another order), every
    level's gradient within 1e-5 of its largest (the atomics' order). bf16:
    both sum in f32 and round once, so the forward and the gradients lie
    within one bf16 step of the plain f32 sums (the plain version on the
    f32 copy of the maps, under the cotangent rounded to bf16, as the
    kernel receives it)."""
    rng = np.random.RandomState(C + R)
    dt = getattr(torch, dtype)
    levels, scales, rois = _pyramid_case(rng, dev, kind, C, R, dt)
    assert (set(RA.roi_levels(rois, len(levels)).tolist())
            == set(range(len(levels))))
    cot = torch.tensor(rng.randn(R, 7, 7, C).astype(np.float32), device=dev)
    before = (RA.launches, RA.bwd_launches)
    got, grads = _align_grads(levels, scales, rois, cot, RA.roi_align_levels)
    torch.cuda.synchronize()
    assert (RA.launches, RA.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert got.dtype == dt and all(g.dtype == dt for g in grads)
    want, want_grads = _align_grads(
        [f.float() for f in levels], scales, rois, cot.to(dt).float(),
        RA.roi_align_levels_reference)
    if dtype == "float32":
        top = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-5 * top
        for g, w in zip(grads, want_grads):
            assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
    else:
        for g, w in [(got, want)] + list(zip(grads, want_grads)):
            assert ((g.float() - w).abs() <= w.abs() * 2.0 ** -7 + 1e-6).all()


def test_roi_align_kernel_edge_padded_and_strided(dev):
    """ROIs flush with the maps' far edges and past them, zero-size padding
    and a one-cell box, with no ROI at stride 16: the forward within 1e-5
    of the plain version's largest output, the empty level's gradient
    exactly zero; the NCHW map read through its strided view (the kernel's
    one-channel path) equal to the channels-last copy's result bit for
    bit."""
    rng = np.random.RandomState(4)
    C = 64
    levels, scales, _ = _pyramid_case(rng, dev, "fpn", C, 8, torch.float32)
    rois = _tens([[900, 700, 1023, 799], [0, 0, 1023, 799], [1000, 0, 1023, 30],
                  [0, 0, 0, 0], [0, 0, 0, 0], [5, 7, 5, 7], [10, 20, 60, 80],
                  [100, 50, 250, 220], [0, 600, 40, 799]], dev)
    fid = RA.roi_levels(rois, 4)
    assert 2 not in fid.tolist() and {0, 1, 3} <= set(fid.tolist())
    cot = torch.tensor(rng.randn(len(rois), 7, 7, C).astype(np.float32),
                       device=dev)
    got, grads = _align_grads(levels, scales, rois, cot, RA.roi_align_levels)
    want, want_grads = _align_grads(levels, scales, rois, cot,
                                    RA.roi_align_levels_reference)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert not grads[2].any()
    for g, w in zip(grads, want_grads):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max() + 1e-30)
    nchw = [f.permute(2, 0, 1).contiguous().permute(1, 2, 0) for f in levels]
    assert not nchw[0].is_contiguous()
    strided = RA._launch(nchw, scales, rois, 7, 2)
    assert torch.equal(strided, got)


def test_roi_align_backward_spread(dev):
    """Two backward runs at the FPN cell's shape: the f32 atomics add in
    another order each run, within 1e-5 of each level's largest element."""
    rng = np.random.RandomState(5)
    levels, scales, rois = _pyramid_case(rng, dev, "fpn", 256, 1016,
                                         torch.float32)
    cot = torch.tensor(rng.randn(1016, 7, 7, 256).astype(np.float32),
                       device=dev)
    shapes = [tuple(f.shape) for f in levels]
    a = RA._launch_bwd(cot, rois, shapes, scales, 7, 2, [True] * 4)
    b = RA._launch_bwd(cot, rois, shapes, scales, 7, 2, [True] * 4)
    for x, y in zip(a, b):
        assert float((x - y).abs().max()) <= 1e-5 * float(y.abs().max())


def test_roi_align_kernel_refuses_bad_inputs(dev):
    f = torch.zeros(8, 8, 4, device=dev)
    rois = torch.zeros(3, 4, device=dev)
    with pytest.raises(ValueError):
        RA.roi_align_levels([f] * 5, [0.25] * 5, rois)
    with pytest.raises(ValueError):
        RA.roi_align_levels([f, torch.zeros(4, 4, 8, device=dev)], [0.25, 0.125],
                            rois)
    with pytest.raises(TypeError):
        RA.roi_align_levels([f.half()], [0.25], rois)
    with pytest.raises(ValueError):
        RA.roi_align_levels([f], [0.25], rois[:, :3])
    with pytest.raises(ValueError):
        RA.roi_align_levels([f], [0.25], rois.cpu())


@pytest.mark.parametrize("feed", ["device", "numpy"])
def test_end2end_steps_never_wait_on_the_card(dev, feed):
    """Two END2END steps of the deformable model (the dcn_learn_nms cell at
    its rehearsal size: every published width, 64x128 images, B=2) under
    ``torch.cuda.set_sync_debug_mode("error")`` raise nothing: no copy from
    pageable memory, no read of a value, no synchronise, so the host
    launches the next step while the card runs this one. The batch lives on
    the card (the benchmark's) or arrives as numpy arrays (the train
    driver's loader), which the step pins and copies without blocking. One
    step before them builds the kernels and warms the allocator."""
    from benchmark.harness import cells
    from benchmark.harness.common import rehearsal
    from benchmark.harness.drivers.train_e2e import INPUTS
    from benchmark.reference import dcn as ref
    spec = cells.resolve("dcn_learn_nms.train_b4")
    config, mix = rehearsal(spec["config"], spec["mix"])
    ctx = {"config": config, "reference": ref, "mix": mix, "seed": 7,
           "device": dev, "rehearse": True, "fault": ""}
    _, state, step, _, batches = cells.driver(mix["kind"]).build(ctx)
    if feed == "numpy":
        batches = [{k: v.cpu().numpy() if k in INPUTS else v
                    for k, v in b.items()} for b in batches]
    state, _ = step(state, batches[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in batches[1:3]:
            state, metrics = step(state, b)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert state.count == 3
    assert np.isfinite(float(metrics["total_loss"]))


def _leaves(tree) -> list:
    """The tensors of a nest of tuples, lists and dicts, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [t for v in tree for t in _leaves(v)]


def test_replayed_graph_equals_the_eager_calls(dev, monkeypatch):
    """utils/graphs.py::replayed on the card: the anchor targets of three
    images (other boxes and priorities, one signature) through the CUDA
    graph equal the eager calls bit for bit, the first call's outputs
    survive the later replays, and a call with another signature captures
    its own graph; proposals through a graph equal the eager ones and count
    one NMS launch a replay. The graphed stages of core/trainer.py, each
    held to its undecorated function over several inputs under one
    signature and one under another: ``sample_fn``'s sampler in take-all
    and in sampled mode (handed priorities), and ``head_losses_fn``'s OHEM
    selection and learned-NMS targets. A launch that another thread counts
    during a capture is not added to the replays' counts."""
    from relation_tpu_torch.models.targets import anchor_targets
    from relation_tpu_torch.ops.anchors import generate_anchors, shift_anchors
    from relation_tpu_torch.utils.graphs import replayed
    rng = np.random.RandomState(4)
    anchors = shift_anchors(torch.tensor(generate_anchors(16, (0.5, 1, 2),
                                                          (4, 8, 16, 32)),
                                         device=dev), 19, 32, 16)
    K = anchors.shape[0]
    w = _tens([1.0, 1.0, 1.0, 1.0], dev)

    def case(G):
        xy = rng.uniform(0, 400, (G, 2))
        gt = np.concatenate([xy, xy + rng.uniform(20, 200, (G, 2)),
                             rng.randint(1, 81, (G, 1))], 1)
        valid = torch.tensor(rng.uniform(0, 1, G) > 0.2, device=dev)
        return (anchors, _tens(gt, dev), valid, _tens([304, 512, 1.0], dev),
                _tens(rng.uniform(0, 1, K), dev), _tens(rng.uniform(0, 1, K), dev))

    def fn(anchors, gt, valid, info, fg, bg):
        return anchor_targets(anchors, gt, valid, info, priorities=(fg, bg),
                              bbox_weights=w)
    graphed = replayed(fn)
    cases = [case(16) for _ in range(3)] + [case(5)]
    got = [graphed(*c) for c in cases]
    want = [fn(*c) for c in cases]
    for g, wt in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g, wt))
    assert not torch.equal(got[0][0], got[1][0])
    assert int((got[0][0] == 1).sum()) > 0

    # proposals, with the NMS kernel inside: each replay counts its launch
    from relation_tpu_torch.models.rpn import generate_proposals
    base = torch.tensor(generate_anchors(16, (0.5, 1, 2), (4, 8, 16, 32)),
                        dtype=torch.float32, device=dev)
    info = _tens([304, 512, 1.0], dev)

    def props(prob, deltas):
        return generate_proposals(prob, deltas, base, info, 16, 600, 100,
                                  0.7, 0.0)[0]
    graphed, counted = replayed(props), []
    for _ in range(3):
        prob = _tens(rng.uniform(0, 1, (19, 32, 12)), dev)
        deltas = _tens(rng.randn(19, 32, 12, 4) * 0.2, dev)
        before = NK.launches
        rois = graphed(prob, deltas)
        counted.append(NK.launches - before)
        assert torch.equal(rois, props(prob, deltas))
    # the first call runs once as it is, then replays its capture
    assert counted == [2, 1, 1]

    # a function that copies from the host cannot be captured: it runs as
    # it is, with a warning, and gives its own results
    def from_host(x):
        return x * torch.tensor(3.0, device=x.device)
    x = _tens(rng.randn(5), dev)
    with pytest.warns(UserWarning, match="without a CUDA graph"):
        y = replayed(from_host)(x)
    assert torch.equal(y, x * 3.0)

    # the trainer's graphed closures, with their undecorated functions
    from relation_tpu_torch.core import trainer
    from relation_tpu_torch.entry import family_cfg
    made = []

    def keep(fn):
        made.append(fn)
        return replayed(fn)
    monkeypatch.setattr(trainer, "replayed", keep)
    cfg = family_cfg("flagship")
    consts = trainer.target_constants(cfg.TRAIN.BBOX_MEANS, cfg.TRAIN.BBOX_STDS,
                                      cfg.TRAIN.BBOX_WEIGHTS, dev)

    def held(call, fn, cases):
        """``call`` on every case equals ``fn`` on it, bit for bit, and
        the first case's outputs survive the later calls."""
        got = [call(*c) for c in cases]
        first = _leaves(got[0])
        want = [_leaves(fn(*c)) for c in cases]
        for g, w in zip(got, want):
            g = _leaves(g)
            assert len(g) == len(w) and all(torch.equal(a, b)
                                            for a, b in zip(g, w))
        assert all(torch.equal(a, b) for a, b in zip(_leaves(got[0]), first))
        assert not all(torch.equal(a, b)
                       for a, b in zip(_leaves(got[0]), _leaves(got[1])))

    def roi_case(R, G, sampled):
        xy = rng.uniform(0, 400, (R, 2))
        rois = np.concatenate([xy, xy + rng.uniform(8, 200, (R, 2))], 1)
        xy = rng.uniform(0, 400, (G, 2))
        gt = np.concatenate([xy, xy + rng.uniform(20, 200, (G, 2)),
                             rng.randint(1, 81, (G, 1))], 1)
        rois[:G] = gt[:, :4] + rng.uniform(-6, 6, (G, 4))
        prio = [_tens(rng.uniform(0, 1, R + G), dev)
                for _ in range(4 if sampled else 0)]
        return (_tens(rois, dev), torch.arange(R, device=dev) < R - 5,
                _tens(gt, dev), torch.tensor(rng.uniform(0, 1, G) > 0.2,
                                             device=dev), *prio)
    for batch_rois in (-1, 32):
        sampled = batch_rois >= 0
        made.clear()
        sample = trainer.sample_fn(cfg, batch_rois, 2, consts, True)
        fn, = made
        cases = [roi_case(300, 8, sampled) for _ in range(3)] + [
            roi_case(120, 3, sampled)]
        held(lambda *c: sample(*c[:4], c[4:] or None), fn, cases)

    made.clear()
    model = trainer.build_model(cfg, tiny=True, device=dev)
    trainer.head_losses_fn(model, cfg)
    ohem, nms_target = made
    assert "ohem_select" in ohem.__code__.co_names
    assert "nms_multi_target" in nms_target.__code__.co_names

    def ohem_case(N):
        label = rng.randint(-1, 81, N)
        return (_tens(rng.randn(N, 81) * 2, dev), _tens(rng.randn(N, 8), dev),
                torch.tensor(label, device=dev), _tens(rng.randn(N, 8), dev),
                _tens((label[:, None] > 0) * np.ones((N, 8)), dev))
    held(replayed(ohem), ohem, [ohem_case(300) for _ in range(3)]
         + [ohem_case(150)])

    def nms_case(F, G):
        xy = rng.uniform(0, 300, (F, 80, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(10, 150, (F, 80, 2))], 2)
        cols = rng.randint(0, 80, G)         # a gt box of class c + 1 near
        gt = np.concatenate([boxes[rng.randint(0, F, G), cols]   # a box of c
                             + rng.uniform(-5, 5, (G, 4)), cols[:, None] + 1], 1)
        return (_tens(boxes, dev), _tens(gt, dev),
                torch.tensor(rng.uniform(0, 1, G) > 0.1, device=dev),
                _tens(np.sort(rng.uniform(0, 1, (F, 80)), 0)[::-1], dev))
    held(replayed(nms_target), nms_target,
         [nms_case(100, 12) for _ in range(3)] + [nms_case(100, 5)])

    # what another thread launches during a capture stays out of the
    # replays' count: proposals captured while a thread launches NMS
    import threading
    go, stop = threading.Event(), threading.Event()

    def launcher():
        s = torch.cuda.Stream(dev)
        with torch.cuda.stream(s):
            bT = torch.rand(1, 4, 256, device=dev).cumsum(1)
            v = torch.ones(1, 256, device=dev)
            go.set()
            while not stop.is_set():
                NK.nms_keep_sorted(bT, v, 0.5, block=256, max_keep=16)
        s.synchronize()
    t = threading.Thread(target=launcher)
    t.start()
    go.wait()
    try:
        graphed = replayed(props)
        prob = _tens(rng.uniform(0, 1, (19, 32, 12)), dev)
        deltas = _tens(rng.randn(19, 32, 12, 4) * 0.2, dev)
        graphed(prob, deltas)
    finally:
        stop.set()
        t.join()
    before = NK.launches
    graphed(prob, deltas)
    assert NK.launches - before == 1


def test_graphed_end2end_steps_equal_the_eager_step(dev, monkeypatch, recwarn):
    """END2END steps of the deformable model (the dcn_learn_nms cell at its
    rehearsal size), each from the same weights on the same batch and
    priorities: two of the step built without graphs, and two of the step
    whose no-gradient stages (anchor targets, proposals, sample_rois, OHEM,
    learned-NMS targets) are CUDA graphs, the first capturing them and the
    second replaying them. Every graphed call equals its undecorated
    function on the same arguments, bit for bit; what a call returned is
    unchanged after the whole step (no later replay wrote over it); the
    stages' outputs of both graphed steps equal the first eager step's, bit
    for bit, image after image; no capture fails. The step itself is not
    bit-reproducible on the card (two eager steps differ in the
    learned-NMS loss by an ulp and in most gradients, from the learned-NMS
    scores and the backward's atomic adds), so the graphed steps' metrics
    equal the eager step's to 1e-6 and their first gradients lie within
    four times the distance between the two eager steps' (over every leaf
    at once)."""
    from benchmark.harness import cells
    from benchmark.harness.common import rehearsal
    from benchmark.reference import dcn as ref
    from relation_tpu_torch.core import trainer
    from relation_tpu_torch.utils.graphs import replayed
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    spec = cells.resolve("dcn_learn_nms.train_b4")
    config, mix = rehearsal(spec["config"], spec["mix"])
    names = ("anchor_targets", "generate_proposals", "sample_rois",
             "ohem_select", "nms_multi_target")
    stages, returned = [], []

    def recorded(graphs):
        def wrap(fn):
            name, = [n for n in names if n in fn.__code__.co_names]
            run = replayed(fn) if graphs else torch.no_grad()(fn)

            def call(*args):
                got = run(*args)
                if graphs:
                    with torch.no_grad():
                        want = fn(*args)
                    g, w = _leaves(got), _leaves(want)
                    assert len(g) == len(w) and all(
                        torch.equal(a, b) for a, b in zip(g, w)), name
                    returned[-1].extend((t, t.clone()) for t in g)
                stages[-1].append((name, [t.clone() for t in _leaves(got)]))
                return got
            return call
        return wrap

    def first_steps(graphs: bool):
        """(metrics, first gradients) of two steps on the first batch,
        each from the built weights."""
        monkeypatch.setattr(trainer, "replayed", recorded(graphs))
        ctx = {"config": config, "reference": ref, "mix": mix, "seed": 7,
               "device": dev, "rehearse": True, "fault": ""}
        model, state, step, W, batches = cells.driver(mix["kind"]).build(ctx)
        update, out = state.tx.update, []

        def keep(m, trace_, count):
            out[-1][1].update({k: p.grad.clone()
                               for k, p in m.named_parameters()
                               if p.grad is not None})
            return update(m, trace_, count)
        state.tx.update = keep
        for _ in range(2):
            model.load_state_dict(W, strict=True)
            out.append(({}, {}))
            stages.append([])
            returned.append([])
            state, metrics = step(state, batches[0])
            out[-1][0].update({k: float(v) for k, v in metrics.items()})
            torch.cuda.synchronize()
            assert all(torch.equal(t, c) for t, c in returned[-1])
        return out

    (want_m, want_g), (_, again_g) = first_steps(False)
    got = first_steps(True)
    assert not [w for w in recwarn if "without a CUDA graph" in str(w.message)]
    assert {n for n, _ in stages[0]} == set(names)
    for run in stages[1:]:
        assert [n for n, _ in run] == [n for n, _ in stages[0]]
        for (n, ts), (_, want) in zip(run, stages[0]):
            assert all(torch.equal(a, b) for a, b in zip(ts, want)), n
    assert all(returned[2:]) and len(want_g) > 10

    def dist(g):
        return float(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g[k] - w) for k, w in want_g.items()])))
    noise = dist(again_g)
    for m, g in got:
        assert m == pytest.approx(want_m, rel=1e-6)
        assert set(g) == set(want_g)
        assert dist(g) <= 4 * noise, (dist(g), noise)
