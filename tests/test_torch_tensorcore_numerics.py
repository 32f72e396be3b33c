"""The arithmetic of the tensor-core kernels, emulated in plain PyTorch on the
CPU and held against the plain f32 versions at the chip check's tolerance:
the d_W/d_b product of csrc/geom_bias_bwd.cu and the scores and attn @ u of
csrc/bias_attention.cu, both mma.sync m16n8k8 with TF32 operands.

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

import numpy as np
import pytest
import torch

from relation_tpu_torch.ops.embeddings import (extract_multi_position_matrix_t,
                                               extract_position_matrix_t)
from relation_tpu_torch.ops.kernels import geom_bias as GB
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
