"""Where the time of the NMS kernel (csrc/nms_kernel.cu) goes, on one CUDA
card, by switching its parts off one at a time, and how it moves with the
cluster size.

    python3 -m relation_tpu_torch.tools.ablate_nms [--csrc DIR]

Builds variants of the source, each a few text substitutions away from it
(tools/_ablate.py: one nvcc per variant, in parallel), each doing one part
twice (VARIANTS below) or launching clusters of one size at every class
count (CLUSTERS below), and times each with CUDA events on seeded inputs:
the proposals' shape (one class, Np 6144, 6000 boxes, max_keep 300) with
chip_smoke.py's boxes and with a crowded class whose walk visits about 22
chunks, and the classic tail's (80 classes, Np 512, 300 boxes, max_keep
100). A time marked * is from a variant whose keep mask differs from the
plain version's.

``--csrc DIR`` times the sources of another checkout instead. Sources of the
two-pass bitmask design (a parallel mask pass over the upper triangle of
all box pairs into a [C, Np, Np/64] scratch, then a serial sweep) are timed
whole and pass by pass.

Prints the card's name and power limit first. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
from pathlib import Path

import numpy as np
import torch

from relation_tpu_torch.ops.kernels import _build
from relation_tpu_torch.ops.kernels import nms_kernel as K
from relation_tpu_torch.tools._ablate import build_variants, print_card, time_ms

NMS = "nms_kernel.cu"
# The walk is data-dependent: a variant that drops a part keeps other boxes
# and visits another number of chunks. So each variant does one part TWICE
# a chunk (the same result: the output stays the plain version's), and its
# time less the full kernel's is that part's cost on the chunk's critical
# path. A __syncwarp (or a compiler barrier) between the two passes keeps
# the compiler from folding them into one.
VARIANTS = {
    "full": [],
    "prefix2": [(NMS, "    bool hit = false;\n    if (vi) {",
                 "    bool hit = false;\n    for (int rep = 0; rep < 2; ++rep) {\n"
                 "    __syncwarp();\n    if (vi) {"),
                (NMS, "    }\n    const uint32_t hits = ", "    }}\n    const uint32_t hits = ")],
    "triangle2": [(NMS, "    for (int it = r * kWarps + warp; it < kItems;",
                   "    for (int rep = 0; rep < 2; ++rep) {\n    __syncwarp();\n"
                   "    for (int it = r * kWarps + warp; it < kItems;"),
                  (NMS, "    // every block's prefix bits and triangle words have landed",
                   "    }\n    // every block's prefix bits and triangle words have landed")],
    "resolve2": [(NMS, "    if (r == 0 && warp == 0) {\n      // the chunk's suppressed-or-invalid",
                  "    for (int rep = 0; rep < 2; ++rep) if (r == 0 && warp == 0) {\n"
                  "      __syncwarp();\n      // the chunk's suppressed-or-invalid")],
    # the triangle's DSMEM stores twice (a compiler barrier between them)
    "stores2": [(NMS, "      *cluster.map_shared_rank(&S.tri[ii * H + hw], 0) = bits;",
                 "      *cluster.map_shared_rank(&S.tri[ii * H + hw], 0) = bits;\n"
                 "      asm volatile(\"\" ::: \"memory\");\n"
                 "      *cluster.map_shared_rank(&S.tri[ii * H + hw], 0) = bits;")],
    "barrier2": [(NMS, "    // every block has the keep words\n    cluster.sync();",
                  "    // every block has the keep words\n    cluster.sync();\n    cluster.sync();")],
}
# clusters of one size at every class count: cluster_size() picks it
_PICK = ("  *cs = 1;\n  for (int c = kMaxCS; c > 1; c /= 2)\n"
         "    if ((long)C * c <= slots) {")
CLUSTERS = {f"cs{cs}": [(NMS, _PICK, _PICK.replace("*cs = 1;", f"*cs = {cs};")
                         .replace("(long)C * c <= slots", "false"))]
            for cs in (1, 2, 4, 8)}
# 16, a non-portable cluster size: the exchange buffer sized for it, the
# kernel allowed it
CLUSTERS["cs16"] = [
    (NMS, _PICK, _PICK.replace("*cs = 1;", "*cs = 16;")
     .replace("(long)C * c <= slots", "false")),
    (NMS, "constexpr int kMaxCS = 8; ", "constexpr int kMaxCS = 16;"),
    (NMS, "    ready = true;",
     "    err = cudaFuncSetAttribute(kernel, "
     "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"
     "    if (err != cudaSuccess) return err;\n    ready = true;")]


def proposal_boxes(rng, n, np_pad, im_w=1000.0, im_h=600.0, clusters=25):
    """chip_smoke.py's proposals: clustered boxes in a random score order,
    [1, 4, np_pad] and valid [1, np_pad]."""
    centers = rng.uniform([0, 0], [im_w, im_h], (clusters, 2))
    cxy = centers[rng.randint(0, clusters, n)] + rng.randn(n, 2) * 12
    wh = np.exp(rng.uniform(np.log(16), np.log(400), (n, 2)))
    b = np.concatenate([cxy - wh / 2, cxy + wh / 2], 1)
    b[:, 0::2] = b[:, 0::2].clip(0, im_w - 1)
    b[:, 1::2] = b[:, 1::2].clip(0, im_h - 1)
    bT = np.zeros((1, 4, np_pad), np.float32)
    bT[0, :, :n] = b.T
    valid = np.zeros((1, np_pad), np.float32)
    valid[0, :n] = 1.0
    return bT, valid


def jittered_objects(rng, n, K, small=False):
    """[n, 4] boxes, each a copy of one of K objects jittered by a few
    pixels and up to 15% in size (fewer objects: more suppression)."""
    centers = rng.uniform(30, 30 + 96 * np.sqrt(K), (K, 2))
    sizes = rng.uniform(8, 16, (K, 2)) if small else rng.uniform(20, 80, (K, 2))
    obj = rng.randint(0, K, n)
    cxy = centers[obj] + rng.uniform(-4, 4, (n, 2))
    wh = sizes[obj] * rng.uniform(0.85, 1.15, (n, 2))
    return np.concatenate([cxy - wh / 2, cxy + wh / 2], 1)


def is_one_launch(lib) -> bool:
    """Whether ``lib`` is the one-launch design (else the two-pass one)."""
    return hasattr(lib, "nms_keep")


def two_pass(lib, bT, v, thresh, block, cap, mask=None):
    """The two-pass design's calls: (keep, mask); with ``mask`` given, the
    sweep alone; with cap < 0 the mask pass alone."""
    C, _, N = bT.shape
    words = -(-N // 64)
    stream = _build.stream_ptr(bT.device)
    if mask is None:
        mask = torch.empty((C, N, words), dtype=torch.int64, device=bT.device)
        fn = lib.nms_mask
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
        _build.check(fn(_build.ptr(bT), C, N, float(thresh), _build.ptr(mask),
                        stream), "nms_mask")
    if cap < 0:
        return None, mask
    keep = torch.empty((C, N), dtype=torch.float32, device=bT.device)
    fn = lib.nms_sweep
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    _build.check(fn(_build.ptr(v), _build.ptr(mask), C, N, int(block), int(cap),
                    _build.ptr(keep), stream), "nms_sweep")
    return keep, mask


def keep_with(lib, bT, v, thresh, block, cap):
    """The keep mask from ``lib``, whichever design it is."""
    if is_one_launch(lib):
        _build._libs["nms_kernel"] = lib
        try:
            return K.launch(bT, v, thresh, block, cap)
        finally:
            _build._libs.pop("nms_kernel", None)
    return two_pass(lib, bT, v, thresh, block, cap)[0]


def cases(dev):
    """(label, boxesT, valid, thresh, block, max_keep) at the shapes of the
    driven paths."""
    rng = np.random.RandomState(0)
    out = []
    bT, v = proposal_boxes(rng, 6000, 6144)
    out.append(("C=1 Np=6144 chip_smoke boxes", bT, v, 0.7, 256, 300))
    bT, v = np.zeros((1, 4, 6144), np.float32), np.zeros((1, 6144), np.float32)
    bT[0, :, :6000], v[0, :6000] = jittered_objects(rng, 6000, 93).T, 1.0
    out.append(("C=1 Np=6144 crowded", bT, v, 0.7, 256, 300))
    bT, v = np.zeros((80, 4, 512), np.float32), np.zeros((80, 512), np.float32)
    for c in range(80):
        bT[c, :, :300] = jittered_objects(rng, 300, 4 ** (1 + c % 4)).T
        v[c, :300 - (c % 5) * 40] = 1.0
    out.append(("C=80 Np=512 classic", bT, v, 0.3, 256, 100))
    return [(lab, torch.tensor(b, device=dev), torch.tensor(x, device=dev), th,
             blk, mk) for lab, b, x, th, blk, mk in out]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", type=Path, default=None,
                    help="csrc/ directory of another checkout (default: this one)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate_nms needs a CUDA card")
    print_card()
    one = "nms_keep(" in ((args.csrc or _build.CSRC) / NMS).read_text()
    libs = build_variants("nms_kernel", {**VARIANTS, **CLUSTERS} if one
                          else {"full": []}, csrc=args.csrc)
    dev = torch.device("cuda", 0)
    for label, bT, v, th, blk, mk in cases(dev):
        want = K.nms_keep_sorted_reference(bT, v, th, blk, mk)
        row = []
        if one:
            for var, lib in libs.items():
                got = keep_with(lib, bT, v, th, blk, mk)
                mark = "" if torch.equal(got, want) else "*"
                _build._libs["nms_kernel"] = lib
                row.append(f"{var} {time_ms(lambda: K.launch(bT, v, th, blk, mk)):.4f}{mark}")
                _build._libs.pop("nms_kernel", None)
        else:
            lib = libs["full"]
            got = keep_with(lib, bT, v, th, blk, mk)
            mark = "" if torch.equal(got, want) else "*"
            mask = two_pass(lib, bT, v, th, blk, -1)[1]
            row += [f"two-pass whole {time_ms(lambda: two_pass(lib, bT, v, th, blk, mk)):.4f}{mark}",
                    f"mask pass {time_ms(lambda: two_pass(lib, bT, v, th, blk, -1)):.4f}",
                    f"sweep {time_ms(lambda: two_pass(lib, bT, v, th, blk, mk, mask)):.4f}"]
        print(f"nms {label} max_keep={mk}: " + "; ".join(row), flush=True)


if __name__ == "__main__":
    main()
