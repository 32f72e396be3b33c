"""Where the time of the deformable col2im kernel (csrc/dconv_col2im.cu) goes,
on one CUDA card, by switching its parts off one at a time.

    python3 -m relation_tpu_torch.tools.ablate_col2im [--old DIR]

Builds variants of the source, each a few text substitutions away from it
(tools/_ablate.py: one nvcc per variant, in parallel), and times each with
CUDA events on chip_smoke.py's inputs (``col2im_inputs``: the DCN train
step's res5 map, 38x64, B=2 and 1, G=4, cg=128, bf16 and f32 rows; and a
100x64 map), then on crowded samples (``crowded_inputs``: the res5 map at
B=2 with two objects whose samples gather at 4x and 8x the mean count a
cell, and the layout of tests/test_torch_cuda.py's crowded-cell test, 70% of
the samples in one cell a (b, g)); each line says how many samples spilled
past the cells' buckets. The kernel's variants: the binning alone (no
gather, no spill pass), the gather with no loads of D, no sums (the binning
and zero stores), no spill pass, the spill pass with a reduction a sample
in place of one a run, an atomic a lane in the binning in place of one a
cell's lanes of a warp, 2 or 8 rows of D in flight in place of 4, buckets
of 16 samples in place of 32, gather blocks of 1 x 16 and 4 x 8 pixels in
place of 2 x 8, three gather blocks an SM in place of two. A time marked *
is from a variant whose dx differs from the plain version's (beyond 1e-5
of its largest element); each checked call writes into a dx filled with
NaN, so a variant that leaves dx unwritten shows.

``--old DIR``: also the global-atomics kernel of another checkout's csrc/
(one thread per sample and 4 channels, red.global.add.v4.f32 into a dx
zeroed by a memset): whole (memset and launch), without the memset, with
plain global stores in place of the reductions, and without the loads of D.

Prints the card's name and power limit first. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
from pathlib import Path

import numpy as np
import torch

from relation_tpu_torch.ops.kernels import _build
from relation_tpu_torch.ops.kernels import dconv_col2im as K
from relation_tpu_torch.tools._ablate import build_variants, print_card, time_ms

SRC = "dconv_col2im.cu"
VARIANTS = {
    "full": [],
    "bins_only": [(SRC, "  if (cg % 4 == 0)\n    gather<T, true>", "  if (false)\n    gather<T, true>"),
                  (SRC, "  else\n    gather<T, false>", "  else if (false)\n    gather<T, false>"),
                  (SRC, "  if (cg % 4 == 0)\n    scatter_spill<T, true>",
                   "  if (false)\n    scatter_spill<T, true>"),
                  (SRC, "  else\n    scatter_spill<T, false>",
                   "  else if (false)\n    scatter_spill<T, false>")],
    "no_load": [(SRC, "if (VEC) v[u] = load4(src);", "if (VEC) v[u] = make_float4(1.f, 1.f, 1.f, 1.f);")],
    "no_sums": [(SRC, "for (int i0 = 0; i0 < total; i0 += 32) {", "for (int i0 = 0; i0 < 0; i0 += 32) {")],
    "no_spill": [(SRC, "  if (cg % 4 == 0)\n    scatter_spill<T, true>",
                  "  if (false)\n    scatter_spill<T, true>"),
                 (SRC, "  else\n    scatter_spill<T, false>",
                  "  else if (false)\n    scatter_spill<T, false>")],
    "no_runs": [(SRC, "if (!((ends >> j) & 1)) continue;", "")],
    "lane_atomics": [(SRC, "take_slot(&count[c], __match_any_sync(live, c))",
                      "atomicAdd(&count[c], 1)"),
                     (SRC, "take_slot(&spilled[bg], __match_any_sync(over, bg))",
                      "atomicAdd(&spilled[bg], 1)")],
    "batch2": [(SRC, "constexpr int kBatch = 4;", "constexpr int kBatch = 2;")],
    "batch8": [(SRC, "constexpr int kBatch = 4;", "constexpr int kBatch = 8;")],
    "cap16": [(SRC, "constexpr int kCap = 32;", "constexpr int kCap = 16;")],
    "tile1x16": [(SRC, "constexpr int kTileY = 2, kTileX = 8;", "constexpr int kTileY = 1, kTileX = 16;")],
    "tile4x8": [(SRC, "constexpr int kTileY = 2, kTileX = 8;", "constexpr int kTileY = 4, kTileX = 8;"),
                (SRC, "__launch_bounds__(32 * kTileY * kTileX, 2)", "__launch_bounds__(32 * kTileY * kTileX, 1)")],
    "occ3": [(SRC, "__launch_bounds__(32 * kTileY * kTileX, 2)", "__launch_bounds__(32 * kTileY * kTileX, 3)")],
}
OLD = {
    "full": [],
    "stores": [(SRC, 'asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"',
                'asm volatile("st.global.v4.f32 [%0], {%1, %2, %3, %4};"')],
    "no_load": [(SRC, "const float4 v = load4(src);",
                 "const float4 v = make_float4(1.f, 1.f, 1.f, 1.f);")],
}


def col2im_inputs(torch, dev, rng, B, G=4, H=38, W=64, kk=9, cg=128):
    """Sample coordinates of a 3x3, dilation-2 deformable conv over an H x W
    map with offsets of a few pixels (many samples leave the map), some set
    exactly on an integer, on -1 and on H, and none within reach of the
    top-left 3x3 pixels, in the [B, S, G] layout; f32 rows [B, S, G, cg]."""
    Q = H * W
    base_y = np.repeat(np.arange(H), W)[:, None, None] - 2.0
    base_x = np.tile(np.arange(W), H)[:, None, None] - 2.0
    tap = np.arange(3) * 2.0
    yy = base_y + np.repeat(tap, 3)[None, :, None] + rng.randn(B, Q, kk, G) * 3.0
    xx = base_x + np.tile(tap, 3)[None, :, None] + rng.randn(B, Q, kk, G) * 3.0
    edge = rng.rand(B, Q, kk, G)
    # nothing lands on the 3x3 pixels of the top-left corner: they must
    # come back exactly zero
    yy = np.where((yy > -1) & (yy < 3) & (xx > -1) & (xx < 3), -5.0, yy)
    yy = np.where(edge < 0.02, np.round(yy), yy)
    yy = np.where((edge >= 0.02) & (edge < 0.03), -1.0, yy)
    yy = np.where((edge >= 0.03) & (edge < 0.04), float(H), yy)
    xx = np.where(edge > 0.98, np.round(xx), xx)
    yy, xx = (torch.tensor(a.reshape(B, Q * kk, G), dtype=torch.float32, device=dev)
              for a in (yy, xx))
    inside = (yy > -1.0) & (yy < H) & (xx > -1.0) & (xx < W)
    zero = torch.zeros_like(yy)
    d = torch.tensor(rng.randn(B, Q * kk, G, cg), dtype=torch.float32, device=dev)
    return torch.where(inside, yy, zero), torch.where(inside, xx, zero), inside, d


def crowded_inputs(torch, dev, rng):
    """Crowded samples, as learned offsets that converge on objects give:
    (name, (yz, xz, inside, d), H, W) of the res5 map at B=2 (col2im_inputs)
    with the samples inside a 16x16 box pulled to its middle 8x8 (4x the
    mean count a cell) and those inside a 17x17 box to its middle 6x6 (8x),
    and as in tests/test_torch_cuda.py::test_col2im_kernel_on_crowded_cells
    (B=2, 6x9, G=2, cg=12, S=3000: 70% of the samples in one cell a (b, g))."""
    yz, xz, inside, d = col2im_inputs(torch, dev, rng, 2)
    for (y0, x0, side, f) in ((6.0, 10.0, 16.0, 2.0), (18.0, 38.0, 17.0, 17 / 6)):
        box = inside & (yz >= y0) & (yz < y0 + side) & (xz >= x0) & (xz < x0 + side)
        cy, cx = y0 + side / 2, x0 + side / 2
        yz = torch.where(box, cy + (yz - cy) / f, yz)
        xz = torch.where(box, cx + (xz - cx) / f, xz)
    objects = ("res5 38x64 B=2 two objects at 4x, 8x", (yz, xz, inside, d), 38, 64)
    B, H, W, G, cg, S = 2, 6, 9, 2, 12, 3000
    yy = torch.tensor(rng.uniform(-1.5, H + 0.5, (B, S, G)), dtype=torch.float32,
                      device=dev)
    xx = torch.tensor(rng.uniform(-1.5, W + 0.5, (B, S, G)), dtype=torch.float32,
                      device=dev)
    crowd = torch.tensor(rng.rand(B, S, G) < 0.7, device=dev)
    yy = torch.where(crowd, 2.25 + 0.5 * torch.rand(B, S, G, device=dev), yy)
    xx = torch.where(crowd, 3.1 + 0.8 * torch.rand(B, S, G, device=dev), xx)
    inside = (yy > -1.0) & (yy < H) & (xx > -1.0) & (xx < W)
    zero = torch.zeros_like(yy)
    d = torch.tensor(rng.randn(B, S, G, cg), dtype=torch.float32, device=dev)
    cells = ("6x9 B=2, 70% in one cell a (b, g)",
             (torch.where(inside, yy, zero), torch.where(inside, xx, zero), inside, d),
             H, W)
    return [objects, cells]


def spilled(yz, xz, inside, H, W):
    """(samples past their cell's bucket of CELL_CAP, samples that reach the
    map, largest count a cell)."""
    B, S, G = yz.shape
    y0, x0 = torch.floor(yz).long(), torch.floor(xz).long()
    ok = inside & (y0 >= -1) & (y0 <= H - 1) & (x0 >= -1) & (x0 <= W - 1)
    nc = (H + 1) * (W + 1)
    bg = torch.arange(B, device=yz.device).view(B, 1, 1) * G \
        + torch.arange(G, device=yz.device).view(1, 1, G)
    key = (bg * nc + (y0 + 1) * (W + 1) + x0 + 1)[ok]
    count = torch.bincount(key, minlength=B * G * nc)
    return (int((count - K.CELL_CAP).clamp(min=0).sum()), int(ok.sum()),
            int(count.max()))


def run_new(lib, yz, xz, inside, d, H, W, dx=None):
    """dx from the kernel in ``lib`` (written into ``dx`` where given)."""
    _build._libs["dconv_col2im"] = lib
    try:
        return K._launch(yz, xz, inside, d, H, W, dx)
    finally:
        _build._libs.pop("dconv_col2im", None)


def run_old(lib, yz, xz, inside, d, H, W, dx=None):
    """dx from the global-atomics kernel in ``lib``: zeroed and written; with
    ``dx`` given, added into it with no memset."""
    B, S, G, cg = d.shape
    if dx is None:
        dx = torch.zeros((B, H, W, G * cg), dtype=torch.float32, device=d.device)
    fn = lib.dconv_col2im
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
    _build.check(fn(_build.ptr(yz), _build.ptr(xz), _build.ptr(inside),
                    _build.ptr(d), int(d.dtype == torch.bfloat16), B, S, G, cg,
                    H, W, _build.ptr(dx), _build.stream_ptr(d.device)),
                 "dconv_col2im (old)")
    return dx


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, default=None,
                    help="csrc/ of a checkout with the global-atomics kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate_col2im needs a CUDA card")
    print_card()
    libs = build_variants("dconv_col2im", VARIANTS)
    old = (build_variants("dconv_col2im", OLD, csrc=args.old, tag="ablate_old")
           if args.old else {})
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(3)
    cases = [(f"{H}x64 B={B}", col2im_inputs(torch, dev, rng, B, H=H), H, 64)
             for B, H in ((2, 38), (1, 38), (1, 100))]
    for label, (yz, xz, inside, d32), H, W in cases + crowded_inputs(torch, dev, rng):
        G, cg = d32.shape[2], d32.shape[3]
        over, reach, most = spilled(yz, xz, inside, H, W)
        for d in (d32.to(torch.bfloat16), d32):
            want = K.dconv_col2im_reference(yz, xz, inside, d, H, W)
            tol = 1e-5 * float(want.abs().max())

            def mark(got):
                return "" if float((got - want).abs().max()) <= tol else "*"
            row = []
            for var, lib in libs.items():
                got = run_new(lib, yz, xz, inside, d, H, W,
                              torch.full_like(want, float("nan")))
                ms = time_ms(lambda: run_new(lib, yz, xz, inside, d, H, W))
                row.append(f"{var} {ms:.4f}{mark(got)}")
            if old:
                dx = torch.zeros_like(want)
                for var, lib in old.items():
                    got = run_old(lib, yz, xz, inside, d, H, W)
                    ms = time_ms(lambda: run_old(lib, yz, xz, inside, d, H, W))
                    row.append(f"old {var} {ms:.4f}{mark(got)}")
                ms = time_ms(lambda: run_old(old["full"], yz, xz, inside, d, H, W, dx))
                row.append(f"old no_memset {ms:.4f}*")
            name = "bf16" if d.dtype == torch.bfloat16 else "f32"
            print(f"[ablate] dconv_col2im {label} G={G} cg={cg} D {name} ({over} "
                  f"of {reach} samples spilled, at most {most} a cell): "
                  + "; ".join(row), flush=True)


if __name__ == "__main__":
    main()
