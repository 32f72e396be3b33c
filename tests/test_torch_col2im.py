"""How the deformable col2im kernel (relation_tpu_torch/csrc/dconv_col2im.cu)
divides its work, emulated in PyTorch on the CPU, in the kernel's order of
sums: the samples of each (b, g) binned by the cell of their top-left corner
(the (H + 1) x (W + 1) cells), the first CELL_CAP of a cell into its bucket
and the rest into the (b, g)'s spill list; then one warp a pixel, which
sums the buckets of its four cells, cell by cell, and stores each element
of dx once; then a last pass takes the spill list in chunks of 8, sums
each run of one cell's samples and adds the run into the cell's pixels.

The emulation is held against the plain version (``dconv_col2im_reference``)
and against the Pallas kernel in interpret mode (fed with ``hat_rows_masked``
of the same coordinates, as tests/test_torch_dcn.py does), at 1e-5 of the
largest element: f32 sums of the same products in another order. The kernel
ranks the samples of a cell, and orders the spill list, with atomics; the
emulation takes sample order, one of the orders the kernel may take.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from relation_tpu.ops.pallas.dconv_col2im import (dconv_col2im as j_col2im,
                                                  hat_rows_masked)
from relation_tpu_torch.ops.kernels import dconv_col2im as tk
from tests.test_torch_helpers import n, t

J = jnp.asarray
SPILL_CHUNK = 8      # spilled samples a warp sums (csrc/dconv_col2im.cu::kChunk)


def bins(yz, xz, inside, H, W, cap=tk.CELL_CAP):
    """Step 1 of the kernel, per (b, g): (cell, rank, y, x, row) of every
    sample that reaches the map, in sample order (row: its index in [B, S,
    G] order), with rank its place among its cell's samples; the ranks below
    ``cap`` fill the cell's bucket, the others go to the spill list. A sample
    inside the map goes to the cell (floor(y) + 1, floor(x) + 1)."""
    B, S, G = yz.shape
    y0, x0 = torch.floor(yz).long(), torch.floor(xz).long()
    ok = inside & (y0 >= -1) & (y0 <= H - 1) & (x0 >= -1) & (x0 <= W - 1)
    cell = (y0 + 1) * (W + 1) + x0 + 1
    row = torch.arange(B * S * G).view(B, S, G)
    out = []
    for b in range(B):
        for g in range(G):
            keep = ok[b, :, g]
            c = cell[b, keep, g]
            order = torch.argsort(c, stable=True)
            first = torch.searchsorted(c[order], c[order], right=False)
            rank = torch.empty_like(c)
            rank[order] = torch.arange(len(c)) - first
            out.append((c, rank, yz[b, keep, g], xz[b, keep, g], row[b, keep, g]))
    return out


def emulate(yz, xz, inside, d, H, W, cap=tk.CELL_CAP):
    """Step 2: each pixel (py, px) sums, for k = 2 i + j in order, the bucket
    of the cell with top-left corner (py - 1 + i, px - 1 + j), of which it
    is the corner (1 - i, 1 - j), in rank order; then step 3 walks the
    spill list in chunks of SPILL_CHUNK, sums each run of samples of one cell from
    zero, in list order, and adds the run's sums into the cell's pixels.
    Returns (dx, spilled samples)."""
    B, S, G, cg = d.shape
    rows = d.reshape(-1, cg).float()
    out = torch.zeros((B * G, H * W, cg))
    spilled = 0
    for bg, (cell, rank, y, x, row) in enumerate(bins(yz, xz, inside, H, W, cap)):
        cy, cx = cell // (W + 1), cell % (W + 1)
        ly, lx = y - torch.floor(y), x - torch.floor(x)
        parts = []
        for k in range(4):
            i, j = k >> 1, k & 1
            py, px = cy - i, cx - j
            ok = (py >= 0) & (py < H) & (px >= 0) & (px < W)
            w = (1 - ly if i else ly) * (1 - lx if j else lx)
            parts.append((ok, py * W + px, w))
        for k, (ok, pix, w) in enumerate(parts):          # the buckets
            sel = ok & (rank < cap)
            by_rank = torch.argsort(rank[sel], stable=True)
            idx = torch.nonzero(sel)[:, 0][by_rank]
            out[bg].index_add_(0, pix[idx], rows[row[idx]] * w[idx, None])
        spill = torch.nonzero(rank >= cap)[:, 0]           # the spill list
        spilled += len(spill)
        for i0 in range(0, len(spill), SPILL_CHUNK):        # a warp's chunk
            chunk = spill[i0:i0 + SPILL_CHUNK].tolist()
            acc = torch.zeros(4, cg)
            for j, s in enumerate(chunk):
                for k, (ok, pix, w) in enumerate(parts):
                    acc[k] += rows[row[s]] * w[s]
                if j + 1 < len(chunk) and cell[chunk[j + 1]] == cell[s]:
                    continue
                for k, (ok, pix, w) in enumerate(parts):   # the run ends
                    if ok[s]:
                        out[bg, pix[s]] += acc[k]
                acc.zero_()
    dx = out.view(B, G, H, W, cg).permute(0, 2, 3, 1, 4).reshape(B, H, W, G * cg)
    return dx, spilled


def _case(rng, B, H, W, G, cg, kk=9, spread=3.0):
    """A 3x3, dilation-2 deformable conv's samples over an H x W map in D's
    order (position-major, then tap), offsets of ``spread`` pixels, and
    adversarial coordinates: on an integer, on -1 and on H (outside), on
    H - 1, in the bands (-1, 0) and (H - 1, H), and anywhere on the map,
    far from the sample's own position."""
    Q = H * W
    by = np.repeat(np.arange(H), W)[:, None, None] - 2.0
    bx = np.tile(np.arange(W), H)[:, None, None] - 2.0
    tap = np.arange(3) * 2.0
    yy = by + np.repeat(tap, 3)[None, :, None] + rng.randn(B, Q, kk, G) * spread
    xx = bx + np.tile(tap, 3)[None, :, None] + rng.randn(B, Q, kk, G) * spread
    yy, xx = (a.reshape(B, Q * kk, G).astype(np.float32) for a in (yy, xx))
    yy[:, 0::13] = np.round(yy[:, 0::13])
    xx[:, 1::13] = np.round(xx[:, 1::13])
    yy[:, 2::23], yy[:, 3::23] = -1.0, float(H)
    xx[:, 4::23], xx[:, 5::23] = -1.0, float(W)
    yy[:, 6::23], xx[:, 6::23] = H - 1.0, W - 1.0
    yy[:, 7::23], yy[:, 8::23] = -0.5, H - 0.25
    yy[:, 9::31] = rng.uniform(-1, H, yy[:, 9::31].shape)
    xx[:, 9::31] = rng.uniform(-1, W, xx[:, 9::31].shape)
    inside = (yy > -1.0) & (yy < H) & (xx > -1.0) & (xx < W)
    d = rng.randn(B, Q * kk, G, cg).astype(np.float32)
    return (np.where(inside, yy, 0).astype(np.float32),
            np.where(inside, xx, 0).astype(np.float32), inside, d)


def _pallas(yz, xz, inside, d, H, W):
    """The Pallas kernel in interpret mode on the same samples, through the
    glue of relation_tpu/ops/deform.py (rows regrouped (b, g)-major, R padded
    to 256)."""
    B, S, G, cg = d.shape

    def bg_rows(a):
        return np.moveaxis(a, 2, 1).reshape((B * G, S) + a.shape[3:])
    by = hat_rows_masked(J(bg_rows(yz)), J(bg_rows(inside)), H, jnp.float32)
    bx = hat_rows_masked(J(bg_rows(xz)), J(bg_rows(inside)), W, jnp.float32)
    rows = J(bg_rows(d))
    pad = (-S) % 256
    by, bx, rows = (jnp.pad(a, ((0, 0), (0, pad), (0, 0))) for a in (by, bx, rows))
    out = np.asarray(j_col2im(by, bx, rows, H, W, interpret=True))
    return out.reshape(B, G, H, W, cg).transpose(0, 2, 3, 1, 4).reshape(B, H, W, G * cg)


@pytest.mark.parametrize("B,H,W,G,cg,cap", [
    (2, 9, 12, 1, 128, tk.CELL_CAP),   # 4 channels a lane, one pass
    (2, 7, 6, 2, 40, tk.CELL_CAP),     # 4 channels a lane, the second lanes idle
    (1, 11, 5, 3, 3, 2),               # cg 3: one channel a lane; buckets of 2
    (1, 100, 64, 1, 3, tk.CELL_CAP),   # a map taller than the res5 map
])
def test_col2im_gather_matches_plain_and_pallas(B, H, W, G, cg, cap):
    rng = np.random.RandomState(H * 100 + W + cg)
    yz, xz, inside, d = _case(rng, B, H, W, G, cg)
    got, spilled = emulate(t(yz), t(xz), t(inside), t(d), H, W, cap)
    assert cap == tk.CELL_CAP or spilled > 0
    want = tk.dconv_col2im_reference(t(yz), t(xz), t(inside), t(d), H, W)
    top = float(want.abs().max())
    assert top > 0
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=1e-5 * top)
    np.testing.assert_allclose(n(got), _pallas(yz, xz, inside, d, H, W), rtol=0,
                               atol=1e-5 * top)


def test_col2im_bins_hold_each_reaching_sample_once():
    """Every sample with a corner on the map is binned once, at the cell of
    its top-left corner (rows and columns -1 .. H - 1, W - 1), with ranks
    0, 1, ... in each cell; samples on -1 or on H are outside and in no
    cell; a crowded cell spills beyond CELL_CAP and the sum stays that of
    the plain version; a pixel that no sample reaches comes back exactly
    zero."""
    rng = np.random.RandomState(4)
    B, H, W, G, cg = 2, 8, 9, 2, 4
    yz, xz, inside, d = _case(rng, B, H, W, G, cg)
    yz[0, :200, 0], xz[0, :200, 0] = 4.5, 5.25               # one cell, crowded
    inside[0, :200, 0] = True
    inside &= ~((yz < 1.5) & (xz < 1.5))                      # (0, 0) clear
    yz, xz = np.where(inside, yz, 0), np.where(inside, xz, 0)
    _, w = tk.corner_weights(t(yz), t(xz), t(inside), H, W)
    reach = n((w > 0).any(0))                                  # [B, S, G]
    for bg, (cell, rank, y, x, row) in enumerate(bins(t(yz), t(xz), t(inside), H, W)):
        b, g = divmod(bg, G)
        assert len(set(row.tolist())) == len(row)              # once each
        s = (row // G) % yz.shape[1]
        assert bool(t(inside)[b, s, g].all())
        assert set(s.tolist()) >= set(np.flatnonzero(reach[b, :, g]).tolist())
        assert float(y.min()) > -1 and float(y.max()) < H
        assert torch.equal(cell, ((torch.floor(y) + 1) * (W + 1)
                                  + torch.floor(x) + 1).long())
        for c in cell.unique():
            assert sorted(rank[cell == c].tolist()) == list(range(int((cell == c).sum())))
    got, spilled = emulate(t(yz), t(xz), t(inside), t(d), H, W)
    assert spilled >= 200 - tk.CELL_CAP
    assert not bool(got[:, 0, 0].any()) and bool(got[:, 1:, 1:].any())
    want = tk.dconv_col2im_reference(t(yz), t(xz), t(inside), t(d), H, W)
    np.testing.assert_allclose(n(got), n(want), rtol=0,
                               atol=1e-5 * float(want.abs().max()))
