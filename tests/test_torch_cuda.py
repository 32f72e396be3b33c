"""The port's CUDA kernels against their plain versions on the card, at small
and ragged shapes and with the options the flagship does not use
(chip_smoke.py holds them at the flagship's shapes). Marked ``cuda`` and
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
