"""The arithmetic of the tensor-core kernels, emulated in plain PyTorch on the
CPU and held against the plain f32 versions at the chip check's tolerance:
the d_W/d_b product of csrc/geom_bias_bwd.cu, the scores and attn @ u of
csrc/bias_attention.cu and the bias product of csrc/nms_attention.cu (rows
6/9, the same attention body after it), all mma.sync m16n8k8 with TF32
operands; and the weight layout of csrc/stem.cu (bf16 mma.sync m16n8k16
A fragments, the GEMM depth padded to 16 channels a tap) against the plain
and JAX stems.

TF32 rounding is cvt.rna: the low 13 of f32's 23 mantissa bits dropped,
to nearest, ties away from zero. A product of two TF32 values is exact in
f64, so each mma is emulated as an f64 product of the k8 step added to the
f32 accumulator and rounded to f32 once. Split TF32 ("3xTF32") is
x = hi + lo with hi = tf32(x), lo = tf32(x - hi), and the sum lo·hi,
hi·lo, then hi·hi, in that order, as mma_tf32.cuh adds them (attn @ u keeps
the three in accumulators of their own). The k8 steps follow the kernels'
order: the backward's 32-pair units walked by the warps of its grid, then
warp sums in warp order and block sums in block order; the attention's
value projection over F, its scores over D onto the bias, then its keys,
eight at a time (one key chunk: N <= 152, both shapes the models give it).

Both kernels keep the 1e-4-of-max band with split TF32, and one TF32
pass does not keep it: the second case is asserted as a failure of the
band, which is why the kernels pay three products a step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relation_tpu.ops.pallas import nms_attention as JNA
from relation_tpu.ops.pallas import stem as JST
from relation_tpu_torch.models.backbone import conv1_w4
from relation_tpu_torch.ops.embeddings import (extract_multi_position_matrix_t,
                                               extract_position_matrix_t)
from relation_tpu_torch.ops.kernels import geom_bias as GB
from relation_tpu_torch.ops.kernels import nms_attention as NA
from relation_tpu_torch.ops.kernels import stem as ST
from relation_tpu_torch.ops.kernels.bias_attention import bias_attention_reference

TOL = 1e-4            # of the largest element: chip_smoke.py and the card tests
SMS, BLOCKS_PER_SM = 132, 4   # the backward's grid on an H100 at G = 16


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on f32 values."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mma(d, x, y):
    """d (f32) += x @ y for TF32 x, y over one k8 step: exact products, one
    rounding to f32."""
    return (d.double() + x.double() @ y.double()).float()


def mma_add(d, a, b, passes):
    """d (f32) += a @ b over one k8 step, as the tensor cores add it: split
    TF32 (``passes`` 3: lo hi, hi lo, hi hi into d) or one TF32 pass (1)."""
    (ah, al), (bh, bl) = split(a), split(b)
    terms = [(al, bh), (ah, bl), (ah, bh)] if passes == 3 else [(tf32(a), tf32(b))]
    for x, y in terms:
        d = mma(d, x, y)
    return d


def matmul_emulated(a, b, passes, separate=False):
    """a [..., M, K] @ b [..., K, N] over k8 steps (K padded with zeros to a
    multiple of 8); with ``separate`` the three split products go to
    accumulators of their own, summed as (lo hi + hi lo) + hi hi at the end."""
    pad = -a.shape[-1] % 8
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    shape = a.shape[:-1] + b.shape[-1:]
    if not separate or passes == 1:
        d = torch.zeros(shape)
        for k in range(0, a.shape[-1], 8):
            d = mma_add(d, a[..., k:k + 8], b[..., k:k + 8, :], passes)
        return d
    o = [torch.zeros(shape) for _ in range(3)]
    for k in range(0, a.shape[-1], 8):
        (ah, al), (bh, bl) = split(a[..., k:k + 8]), split(b[..., k:k + 8, :])
        o = [mma(o[0], al, bh), mma(o[1], ah, bl), mma(o[2], ah, bh)]
    return (o[0] + o[1]) + o[2]


def random_boxes(rng, n, im_w=1000.0, im_h=600.0, clusters=60):
    """Clustered boxes like RPN proposals (chip_smoke.py's generator)."""
    centers = rng.uniform([0, 0], [im_w, im_h], (clusters, 2))
    cxy = centers[rng.randint(0, clusters, n)] + rng.randn(n, 2) * 12
    wh = np.exp(rng.uniform(np.log(16), np.log(400), (n, 2)))
    b = np.concatenate([cxy - wh / 2, cxy + wh / 2], 1)
    b[:, 0::2] = b[:, 0::2].clip(0, im_w - 1)
    b[:, 1::2] = b[:, 1::2].clip(0, im_h - 1)
    return torch.tensor(b.astype(np.float32))


# --------------------------------------------------------------------------
# row 2: the geometric-bias backward's d_W / d_b product
# --------------------------------------------------------------------------

def dwb_emulated(trig, dacc, passes):
    """[65, G] = [trig; 1] [65, P] x dacc^T [P, G], in the kernel's order:
    units of 32 pairs, block b taking units [b U / B, (b + 1) U / B), its
    warp w every fourth from the w-th, four k8 steps a unit; then the warp
    sums in warp order and the block partials in block order."""
    G, P = dacc.shape
    U = -(-P // 32)
    B = min(-(-U // 4), SMS * BLOCKS_PER_SM)
    pad = U * 32 - P
    a = torch.cat([trig, torch.ones(1, P)], 0)                   # [65, P]
    a = torch.nn.functional.pad(a, (0, pad)).reshape(65, U, 32)
    bm = torch.nn.functional.pad(dacc, (0, pad)).reshape(G, U, 32)
    starts = [b * U // B for b in range(B + 1)]
    # chains (block, warp) and their units, in order
    chains = [[list(range(starts[b] + w, starts[b + 1], 4)) for w in range(4)]
              for b in range(B)]
    flat = [c for blk in chains for c in blk]
    steps = max(len(c) for c in flat)
    acc = torch.zeros(len(flat), 65, G)
    for s in range(steps):
        idx = torch.tensor([c[s] if s < len(c) else -1 for c in flat])
        live = (idx >= 0).float()[:, None, None]
        ua = a[:, idx.clamp_min(0)].permute(1, 0, 2) * live      # [W, 65, 32]
        ub = bm[:, idx.clamp_min(0)].permute(1, 2, 0) * live      # [W, 32, G]
        for kk in range(4):
            acc = mma_add(acc, ua[:, :, 8 * kk:8 * kk + 8],
                          ub[:, 8 * kk:8 * kk + 8], passes)
    per_block = acc.reshape(B, 4, 65, G)
    partial = per_block[:, 0]
    for w in range(1, 4):
        partial = partial + per_block[:, w]
    out = partial[0]
    for b in range(1, B):
        out = out + partial[b]
    return out


def _bwd_inputs(C, N, M, seed):
    rng = np.random.RandomState(seed)
    G = 16
    w = torch.tensor(rng.randn(64, G) * 0.1, dtype=torch.float32)
    b = torch.tensor(rng.randn(G) * 0.05, dtype=torch.float32)
    if C == 1:
        pos = extract_position_matrix_t(random_boxes(rng, N), M)[None]
    else:
        pos = extract_multi_position_matrix_t(torch.stack(
            [random_boxes(rng, N) for _ in range(C)], 1))
    acc = GB.geom_acc_reference(pos, w, b)
    clear = (acc > 2e-2) | (acc < -1e-3)
    gout = torch.tensor(rng.randn(C, G, N, M), dtype=torch.float32) * clear
    return pos.contiguous(), w, b, gout


def _trig_dacc(pos, w, b, gout):
    """trig [64, P] and d_acc [G, P] of every pair, as the plain version
    forms them (pairs ordered class-major, as the kernel numbers them)."""
    trig = GB._trig(pos, 100.0)                                  # [C, 64, N, M]
    acc = GB.geom_acc_reference(pos, w, b)
    dacc = torch.where(acc > 1e-6, gout / torch.clamp_min(acc, 1e-6),
                       torch.zeros_like(acc))
    C, G = acc.shape[:2]
    return (trig.permute(1, 0, 2, 3).reshape(64, -1),
            dacc.permute(1, 0, 2, 3).reshape(G, -1))


# C=80, N=M=100 (the learned-NMS head) cut to 4 classes; C=1, 316x300 (the
# head's relation modules in training) at full size
@pytest.mark.parametrize("C,N,M", [(4, 100, 100), (1, 316, 300)])
def test_geom_bias_bwd_product_split_tf32_holds_the_band(C, N, M):
    pos, w, b, gout = _bwd_inputs(C, N, M, seed=C + N)
    _, d_w, d_b = GB.geom_bias_bwd_reference(pos, w, b, gout)
    want = torch.cat([d_w, d_b[None]], 0)
    trig, dacc = _trig_dacc(pos, w, b, gout)
    errs = {}
    for passes in (3, 1):
        got = dwb_emulated(trig, dacc, passes)
        errs[passes] = [float((got[r] - want[r]).abs().max() / want[r].abs().max())
                        for r in (slice(0, 64), slice(64, 65))]
    assert max(errs[3]) <= TOL, errs
    # one TF32 pass misses the band: d_W or d_b off by more than 1e-4 of max
    assert max(errs[1]) > TOL, errs


# --------------------------------------------------------------------------
# rows 7/8: the bias attention's scores and attn @ u
# --------------------------------------------------------------------------

def bias_attention_emulated(bias, q, k, v, wl, passes_qk, passes_pv):
    """The kernels' arithmetic: u = v @ Wl per head over k8 steps of F;
    S = bias + (q / sqrt(D)) k^T over k8 steps of D, accumulated onto the
    bias; exp(S - max) and its row sum in f32; P u over k8 steps of the keys
    (padded with zero rows), each split product in an accumulator of its
    own; divided by the row sum. ``passes_pv`` also sets the projection's."""
    C, G, N, _ = bias.shape
    D = q.shape[2] // G
    Fd, E = wl.shape[1], wl.shape[2]
    qg = q.reshape(C, N, G, D).transpose(1, 2) * (1.0 / torch.sqrt(
        torch.tensor(float(D))))                                 # [C, G, N, D]
    kg = k.reshape(C, N, G, D).permute(0, 2, 3, 1)               # [C, G, D, N]
    s = bias.clone()
    for kk in range(0, D, 8):
        s = mma_add(s, qg[..., kk:kk + 8], kg[:, :, kk:kk + 8], passes_qk)
    p = torch.exp(s - s.max(-1, keepdim=True).values)
    rs = p.sum(-1, keepdim=True)
    w = wl.permute(1, 0, 2).reshape(Fd, G * E)                  # [F, G*E]
    u = matmul_emulated(v, w, passes_pv)                         # [C, N, G*E]
    u = u.reshape(C, N, G, E).transpose(1, 2)                    # [C, G, N, E]
    o = matmul_emulated(p, u, passes_pv, separate=True)
    return (o / rs).transpose(1, 2).reshape(C, N, G * E)


def _attention_inputs(C, N, seed, G=16, D=64, Fd=128, E=8):
    """chip_smoke.py's inputs of rows 7/8 (attention_inputs), C classes."""
    rng = np.random.RandomState(seed)

    def tens(x):
        return torch.tensor(x, dtype=torch.float32)
    pos = extract_multi_position_matrix_t(torch.stack(
        [random_boxes(rng, N) for _ in range(C)], 1)).contiguous()
    q, k = tens(rng.randn(C, N, G * D) * 0.5), tens(rng.randn(C, N, G * D) * 0.5)
    v = tens(rng.randn(C, N, Fd))
    wg, bg = tens(rng.randn(64, G) * 0.1), tens(rng.randn(G) * 0.05)
    wl = tens(rng.randn(G, Fd, E) * 0.1)
    return GB.geom_bias_reference(pos, wg, bg), q, k, v, wl


# N=100 (the C4 learned-NMS tail) and N=150 (the FPN tail), 3 of 80 classes
@pytest.mark.parametrize("N", [100, 150])
def test_bias_attention_split_tf32_holds_the_band(N):
    bias, q, k, v, wl = _attention_inputs(3, N, seed=N)
    want = bias_attention_reference(bias, q, k, v, wl)
    tol = TOL * max(1.0, float(want.abs().max()))

    def err(pqk, ppv):
        got = bias_attention_emulated(bias, q, k, v, wl, pqk, ppv)
        return float((got - want).abs().max())
    split_err = err(3, 3)
    assert split_err <= tol, (split_err, tol)
    # one TF32 pass misses the band, in both products and in attn @ u alone
    # (P in [0, 1] against u: the larger error of the two products)
    for pqk, ppv in ((1, 1), (3, 1)):
        single = err(pqk, ppv)
        assert single > tol, (pqk, ppv, single, tol)


# --------------------------------------------------------------------------
# rows 6/9: the fused attention's bias product on the tensor cores
# --------------------------------------------------------------------------

def fused_bias_emulated(pos, wg, bg, passes=3):
    """The bias of csrc/nms_attention.cu: trig [pairs, 64] x Wg [64, G] over
    k8 steps in feature order (step s holds features 8 s .. 8 s + 7: field
    s // 2, sines for even s, cosines for odd), each step's split products
    lo hi, hi lo, hi hi into one accumulator (mma3); then + bg and
    log(max(., 1e-6)). The heads of a cluster are columns of one product and
    do not mix, so the cluster size does not enter."""
    trig = GB._trig(pos, 100.0)                                  # [C, 64, N, M]
    C, _, N, M = trig.shape
    G = wg.shape[1]
    a = trig.permute(0, 2, 3, 1).reshape(-1, 64)
    acc = torch.zeros(a.shape[0], G)
    for k in range(0, 64, 8):
        acc = mma_add(acc, a[:, k:k + 8], wg[k:k + 8], passes)
    acc = acc.reshape(C, N, M, G).permute(0, 3, 1, 2)
    return torch.log(torch.clamp_min(acc + bg[None, :, None, None], 1e-6))


def _fused_inputs(C, N, seed, G=16, D=64, Fd=128, E=8):
    """chip_smoke.py's inputs of rows 6/9 (attention_inputs), C classes."""
    rng = np.random.RandomState(seed)

    def tens(x):
        return torch.tensor(x, dtype=torch.float32)
    pos = extract_multi_position_matrix_t(torch.stack(
        [random_boxes(rng, N) for _ in range(C)], 1)).contiguous()
    q, k = tens(rng.randn(C, N, G * D) * 0.5), tens(rng.randn(C, N, G * D) * 0.5)
    v = tens(rng.randn(C, N, Fd))
    wg, bg = tens(rng.randn(64, G) * 0.1), tens(rng.randn(G) * 0.05)
    wl = tens(rng.randn(G, Fd, E) * 0.1)
    return pos, q, k, v, wg, bg, wl


# N=100 (the C4 learned-NMS head) and N=150 (the FPN head), 2 of 3 classes
# active: one key chunk, the shapes the models give rows 6/9
@pytest.mark.parametrize("N", [100, 150])
def test_fused_attention_split_tf32_holds_the_band(N):
    pos, q, k, v, wg, bg, wl = _fused_inputs(3, N, seed=N + 1)
    active = torch.tensor([1, 0, 1], dtype=torch.int32)
    on = active.bool()
    bias = fused_bias_emulated(pos[on], wg, bg)
    got = bias_attention_emulated(bias, q[on], k[on], v[on], wl, 3, 3)
    want = NA.nms_relation_attention_reference(pos, q, k, v, wg, bg, wl,
                                               active)[on]
    tol = TOL * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol
    idx = np.flatnonzero(active.numpy())
    jx = [jnp.asarray(t.numpy()[idx]) for t in (pos, q, k, v)]
    want_jax = torch.tensor(np.asarray(JNA.nms_relation_attention_reference(
        *jx, jnp.asarray(wg.numpy()), jnp.asarray(bg.numpy()),
        jnp.asarray(wl.numpy()))))
    assert float((got - want_jax).abs().max()) <= tol


# --------------------------------------------------------------------------
# row 5: the stem's weight as mma.sync m16n8k16 A fragments, K padded
# --------------------------------------------------------------------------

# element e of a lane's A fragment (a0..a7, PTX ISA "Matrix Fragments for
# mma.m16n8k16" with .bf16): (row offset from gid, column offset from 2 tig)
A_FRAG = [(0, 0), (0, 1), (8, 0), (8, 1), (0, 8), (0, 9), (8, 8), (8, 9)]


def unpack_fragments(wf):
    """[4, 16, 32, 8] fragments -> the padded [64, 256] weight (row o,
    column tap * 16 + channel) and how many fragment slots hit each entry."""
    w = torch.zeros(64, 256, dtype=torch.float64)
    hits = torch.zeros(64, 256, dtype=torch.int64)
    for mt in range(4):
        for s in range(16):
            for lane in range(32):
                gid, tig = lane // 4, lane % 4
                for e, (dr, dc) in enumerate(A_FRAG):
                    o, col = 16 * mt + gid + dr, 16 * s + 2 * tig + dc
                    w[o, col] = float(wf[mt, s, lane, e])
                    hits[o, col] += 1
    return w, hits


def _stem_case(B, Ho, Wo, seed):
    rng = np.random.RandomState(seed)
    s2d = torch.tensor(rng.randn(B, 12, Ho, Wo) * 40, dtype=torch.float32)
    w4 = conv1_w4(torch.tensor(rng.randn(64, 3, 7, 7) * (1 / 147) ** 0.5,
                               dtype=torch.float32))
    scale = torch.tensor(rng.uniform(0.5, 2, 64), dtype=torch.float32)
    bias = torch.tensor(rng.randn(64), dtype=torch.float32)
    return s2d, w4, scale, bias


def test_stem_weight_fragments_are_the_padded_weight():
    """Every entry of the padded [64, 16 taps x 16 channels] weight is in
    exactly one fragment slot: channels 0..11 of a tap are the bf16 w4 row
    tap * 12 + channel, channels 12..15 are zeros (the padded K)."""
    _, w4, _, _ = _stem_case(1, 3, 5, seed=0)
    w, hits = unpack_fragments(ST.stem_weight_fragments(w4))
    assert bool((hits == 1).all())
    w = w.reshape(64, 16, 16)
    want = w4.to(torch.bfloat16).double().reshape(16, 12, 64).permute(2, 0, 1)
    assert torch.equal(w[:, :, :12], want)
    assert bool((w[:, :, 12:] == 0).all())


# (2, 37, 45) and (1, 64, 130): the card tests' ragged shapes, cut in rows
@pytest.mark.parametrize("B,Ho,Wo", [(2, 11, 45), (1, 6, 130)])
def test_stem_padded_k_gemm_matches_the_references(B, Ho, Wo):
    """The kernel's GEMM from the fragment layout, K padded to 16 channels a
    tap: its exact (f64) pre-activation equals the unpadded product of
    stem_reference's operands exactly; rounded once to f32 (the kernel's
    exact path) its output equals stem_reference's exactly, and is within
    one bf16 ulp of JAX's stem_reference (an f32 sum in another order)."""
    s2d, w4, scale, bias = _stem_case(B, Ho, Wo, seed=Ho)
    w, _ = unpack_fragments(ST.stem_weight_fragments(w4))        # [64, 256]
    sp = torch.nn.functional.pad(s2d.to(torch.bfloat16).double(), (2, 1, 2, 1))
    taps = torch.stack([sp[:, :, dh:dh + Ho, dw:dw + Wo]
                        for dh in range(4) for dw in range(4)], 1)  # [B,16,12,..]
    padded = torch.nn.functional.pad(taps, (0, 0, 0, 0, 0, 4))     # 16 channels
    acc = torch.einsum("ok,bkn->bon", w, padded.reshape(B, 256, Ho * Wo))
    plain = torch.einsum("ko,bkn->bon", w4.to(torch.bfloat16).double(),
                         taps.reshape(B, 192, Ho * Wo))
    assert torch.equal(acc, plain)
    y = torch.relu(acc.float() * scale[None, :, None] + bias[None, :, None])
    got = y.to(torch.bfloat16).float().reshape(B, 64, Ho, Wo)
    want = ST.stem_reference(s2d, w4, scale, bias).float()
    want_jax = torch.stack([torch.tensor(np.asarray(JST.stem_reference(
        jnp.asarray(s2d[b].numpy()), jnp.asarray(w4.numpy()),
        jnp.asarray(scale.numpy()), jnp.asarray(bias.numpy())).astype(
            jnp.float32))) for b in range(B)])
    assert torch.equal(got, want)
    diff = (got - want_jax).abs()
    assert bool((diff <= want_jax.abs() * 2.0 ** -7 + 1e-4).all())
