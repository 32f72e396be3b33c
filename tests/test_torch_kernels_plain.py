"""Port parity: the plain PyTorch version of each ported kernel against the
relation_tpu Pallas kernel run in interpret mode on the CPU, and the public
wrappers' CPU dispatch. (The CUDA kernels themselves are held against these
plain versions on the card by chip_smoke.py.)"""

import numpy as np
import pytest
import jax.numpy as jnp

from tests.test_torch_helpers import NMS_EDGE_CASES, n, nms_edge_case, t
from relation_tpu_torch.ops.kernels import (geom_bias as tg, nms_attention as ta,
                                            nms_kernel as tn, stem as ts)


def test_geom_bias_plain_matches_pallas(rng):
    """C=3, N=M=12. Against the JAX jnp reference (exact sin/cos, the formula
    the plain version ports) at rtol=atol=1e-4 in the acc domain exp(bias):
    log() near the 1e-6 clamp amplifies any rounding difference without
    bound, so the log itself is held to 1e-4 only where acc is clear of the
    clamp. Against the Pallas kernel (interpret mode) in the band of its own
    test (tests/test_pallas_kernels.py): its polynomial sin/cos reduces
    arguments of several hundred rad with an f32 2*pi and is off by up to
    ~2e-3 in acc at |pos| ~ 5, which a 1e-4 band cannot hold."""
    from relation_tpu.ops.pallas.geom_bias import (fused_geometric_bias as jg,
                                                   geom_bias_reference as jr)
    C, N, M, G = 3, 12, 12, 16
    pos = (rng.randn(C, 4, N, M) * 1.5).astype(np.float32)
    w = (rng.randn(64, G) * 0.1).astype(np.float32)
    b = (rng.randn(G) * 0.05).astype(np.float32)
    jargs = (jnp.asarray(pos), jnp.asarray(w), jnp.asarray(b))
    want = np.asarray(jr(*jargs))
    got = n(tg.geom_bias_reference(t(pos), t(w), t(b)))
    assert got.shape == want.shape == (C, G, N, M)
    np.testing.assert_allclose(np.exp(got), np.exp(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.exp(got), np.exp(np.asarray(jg(*jargs))),
                               rtol=5e-3, atol=2e-3)
    clear = np.exp(want) > 0.05
    assert clear.mean() > 0.2
    np.testing.assert_allclose(got[clear], want[clear], rtol=1e-4, atol=1e-4)
    # the public wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(n(tg.fused_geometric_bias(t(pos), t(w), t(b))),
                                  got)


def _clustered_boxes(rng, C, n_boxes):
    out = []
    for _ in range(C):
        centers = rng.uniform(40, 400, (12, 2))
        cxy = centers[rng.randint(0, 12, n_boxes)] + rng.uniform(-12, 12, (n_boxes, 2))
        wh = rng.uniform(15, 70, (n_boxes, 2))
        out.append(np.concatenate([cxy - wh / 2, cxy + wh / 2], 1).T)
    return np.stack(out).astype(np.float32)                  # [C, 4, n]


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
@pytest.mark.parametrize("max_keep", [None, 8, 40])
def test_nms_plain_matches_pallas(thresh, max_keep):
    """C=2, Np=256 in blocks of 128 (so the early stop happens between
    blocks), invalid boxes included: keep masks exactly equal."""
    from relation_tpu.ops.pallas.nms_kernel import nms_keep_sorted as jn
    rng = np.random.RandomState(int(thresh * 10) + (max_keep or 0))
    bT = _clustered_boxes(rng, 2, 256)
    valid = (rng.uniform(0, 1, (2, 256)) > 0.1).astype(np.float32)
    want = np.asarray(jn(jnp.asarray(bT), jnp.asarray(valid), thresh=thresh,
                         block=128, max_keep=max_keep, interpret=True))
    got = n(tn.nms_keep_sorted(t(bT), t(valid), thresh, block=128,
                               max_keep=max_keep))
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0


@pytest.mark.parametrize("block", [64, 256])
@pytest.mark.parametrize("kind", NMS_EDGE_CASES)
def test_nms_plain_matches_pallas_edge_cases(kind, block):
    """C=3, Np=512 (500 boxes), max_keep 40: the cases a kernel that walks
    the boxes chunk by chunk can get wrong (tests/test_torch_helpers.py::
    nms_edge_case), each checked to be the case it names; keep masks
    exactly equal to the Pallas kernel's in interpret mode."""
    from relation_tpu.ops.pallas.nms_kernel import nms_keep_sorted as jn
    max_keep = 40
    bT, valid, thresh = nms_edge_case(kind, 3, 512, 500, seed=block + 11)
    want = np.asarray(jn(jnp.asarray(bT), jnp.asarray(valid), thresh=thresh,
                         block=block, max_keep=max_keep, interpret=True))
    got = n(tn.nms_keep_sorted(t(bT), t(valid), thresh, block=block,
                               max_keep=max_keep))
    np.testing.assert_array_equal(got, want)
    kept = want.sum(1)
    last = [int(np.nonzero(k)[0].max()) for k in want if k.any()]
    if kind == "mid_block_stop":      # the block in progress was finished
        assert (kept > max_keep).all() and (kept < 500).all()
    if kind == "exact_ties":          # IoU exactly 0.5 in f32
        pair = np.arange(2, 500, 3)
        a, b = bT[:, :, pair - 1], bT[:, :, pair]
        one = np.float32(1)
        iw = np.minimum(a[:, 2], b[:, 2]) - np.maximum(a[:, 0], b[:, 0]) + one
        ih = np.minimum(a[:, 3], b[:, 3]) - np.maximum(a[:, 1], b[:, 1]) + one
        inter = iw * ih
        area = lambda x: (x[:, 2] - x[:, 0] + one) * (x[:, 3] - x[:, 1] + one)
        uni = area(a) + area(b) - inter
        assert int((inter == np.float32(thresh) * uni).sum()) > 100
    if kind == "degenerate":
        assert bool(((bT[:, 2] < bT[:, 0]) | (bT[:, 3] < bT[:, 1])).any())
    if kind == "invalid_class":
        assert kept[0] == 0 and (kept[1:] > 0).all()
    if kind == "staggered_stops":     # the classes stop in different chunks
        assert len({i // block for i in last}) > 1


def test_stem_plain_matches_pallas(rng):
    """[12, 32, 128] s2d input: bf16 output, compared at rtol=atol=1e-2
    (about one bf16 ulp at these magnitudes)."""
    from relation_tpu.ops.pallas.stem import stem_conv1_bn_relu as js
    s2d = (rng.randn(12, 32, 128) * 10).astype(np.float32)
    w4 = (rng.randn(192, 64) * 0.05).astype(np.float32)
    scale = rng.uniform(0.5, 2, 64).astype(np.float32)
    bias = rng.randn(64).astype(np.float32)
    want = np.asarray(js(jnp.asarray(s2d), jnp.asarray(w4), jnp.asarray(scale),
                         jnp.asarray(bias), interpret=True), np.float32)
    got = ts.stem_conv1_bn_relu(t(s2d)[None], t(w4), t(scale), t(bias))
    assert got.dtype.is_floating_point and str(got.dtype) == "torch.bfloat16"
    np.testing.assert_allclose(n(got)[0], want, rtol=1e-2, atol=1e-2)


def test_skip_attention_plain_matches_pallas(rng):
    """C=4, N=8 with classes 1 and 3 inactive. Active rows: against the
    JAX jnp reference at atol=1e-4; against the Pallas skip kernel
    (interpret mode) at 1e-2, since the polynomial sin/cos of its bias (see
    above) moves single outputs by up to 4.8e-3 at this seed. Inactive rows are unwritten on the TPU
    and zero here."""
    from relation_tpu.ops.pallas.nms_attention import (
        fused_nms_relation_attention_skip as jk,
        nms_relation_attention_reference as jref)
    C, N, G, D, F, E = 4, 8, 16, 64, 128, 8
    pos = rng.randn(C, 4, N, N).astype(np.float32)
    q = (rng.randn(C, N, G * D) * 0.2).astype(np.float32)
    k = (rng.randn(C, N, G * D) * 0.2).astype(np.float32)
    v = rng.randn(C, N, F).astype(np.float32)
    wg = (rng.randn(64, G) * 0.1).astype(np.float32)
    bg = (rng.randn(G) * 0.05).astype(np.float32)
    wl = (rng.randn(G, F, E) * 0.1).astype(np.float32)
    active = np.array([1, 0, 1, 0], np.int32)
    args = (pos, q, k, v, wg, bg, wl, active)
    want = np.asarray(jref(*map(jnp.asarray, args[:-1])))
    pallas = np.asarray(jk(*map(jnp.asarray, args), interpret=True))
    got = n(ta.fused_nms_relation_attention_skip(*map(t, args)))
    assert got.shape == (C, N, G * E)
    on = active.astype(bool)
    np.testing.assert_allclose(got[on], want[on], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[on], pallas[on], rtol=1e-2, atol=1e-2)
    assert not got[~on].any()


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing(rng):
    """Dispatch is by the tensor's device alone: on CPU tensors each public
    kernel function returns its plain version's result and no launch
    counter moves (tests/test_torch_cuda.py covers CUDA tensors)."""
    counters = [m.launches for m in (tg, tn, ts, ta)]
    pos = t((rng.randn(2, 4, 5, 5)).astype(np.float32))
    w, b = t((rng.randn(64, 4) * 0.1).astype(np.float32)), t(np.zeros(4, np.float32))
    assert n(tg.fused_geometric_bias(pos, w, b)).tobytes() == \
        n(tg.geom_bias_reference(pos, w, b)).tobytes()
    bT = t(_clustered_boxes(rng, 1, 128))
    valid = t(np.ones((1, 128), np.float32))
    assert np.array_equal(n(tn.nms_keep_sorted(bT, valid, 0.5, block=128)),
                          n(tn.nms_keep_sorted_reference(bT, valid, 0.5, 128)))
    s2d = t(rng.randn(1, 12, 4, 6).astype(np.float32))
    w4, sc, bi = (t(rng.randn(*s).astype(np.float32)) for s in ((192, 64), (64,), (64,)))
    assert np.array_equal(n(ts.stem_conv1_bn_relu(s2d, w4, sc, bi)),
                          n(ts.stem_reference(s2d, w4, sc, bi)))
    q = t(rng.randn(2, 5, 16 * 4).astype(np.float32))
    v = t(rng.randn(2, 5, 8).astype(np.float32))
    wl = t(rng.randn(4, 8, 2).astype(np.float32))
    act = t(np.array([0, 1], np.int32))
    args = (pos, q, q, v, w, b, wl, act)
    assert np.array_equal(n(ta.fused_nms_relation_attention_skip(*args)),
                          n(ta.nms_relation_attention_reference(*args)))
    assert [m.launches for m in (tg, tn, ts, ta)] == counters
