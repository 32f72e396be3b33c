"""Host-side detection helpers (port of relation_tpu/utils/native.py): ctypes
bindings of the native library native/detops.cpp, each with the NumPy
version beside it that runs where the library cannot be built.

The library is compiled on first use by the host C++ compiler with the
flags of native/Makefile into relation_tpu_torch/_build/ (listed in
.gitignore), named by a hash of the source and the flags, as
ops/kernels/_build.py builds the CUDA kernels; nothing is written into
native/. ``have_native()`` says which route runs. ``bbox_overlaps`` is
NumPy only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / "native" / "detops.cpp"
BUILD_DIR = _PKG / "_build"
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]

_lib = None
_lock = threading.Lock()


def _lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    return BUILD_DIR / f"libdetops_{h.hexdigest()[:16]}.so"


def _build() -> Path | None:
    """The library's path, compiled first if missing; None where there is
    no source or no compiler, or the build fails."""
    if not SOURCE.exists():
        return None
    out = _lib_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXXFLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _build()
        try:
            lib = ctypes.CDLL(str(path)) if path else False
        except OSError:
            lib = False
        if lib:
            _declare(lib)
        _lib = lib
    return _lib


def _declare(lib) -> None:
    c_f32p = ctypes.POINTER(ctypes.c_float)
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    c_u32p = ctypes.POINTER(ctypes.c_uint32)
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    lib.greedy_nms.restype = ctypes.c_int64
    lib.greedy_nms.argtypes = [c_f32p, ctypes.c_int64, ctypes.c_float, c_i64p]
    lib.soft_nms.restype = ctypes.c_int64
    lib.soft_nms.argtypes = [c_f32p, ctypes.c_int64, ctypes.c_float,
                             ctypes.c_int64, c_i64p, c_f32p]
    lib.rle_encode.restype = ctypes.c_int64
    lib.rle_encode.argtypes = [c_u8p, ctypes.c_int64, ctypes.c_int64, c_u32p,
                               ctypes.c_int64]
    lib.rle_decode.argtypes = [c_u32p, ctypes.c_int64, ctypes.c_int64,
                               ctypes.c_int64, c_u8p]
    lib.rle_iou.restype = ctypes.c_double
    lib.rle_iou.argtypes = [c_u32p, ctypes.c_int64, c_u32p, ctypes.c_int64,
                            ctypes.c_int]
    # void* and raw .ctypes.data ints: summarize calls this once an
    # (image, class) pair
    lib.coco_match_image.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,  # ious, D, G
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64,                  # thrs, T
        ctypes.c_void_p, ctypes.c_int64,                  # area_rng, A
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def have_native() -> bool:
    """True where the native library is built and loaded (the route every
    function below takes), False where the NumPy versions run."""
    return bool(_load())


def _ptr(a, ty):
    return a.ctypes.data_as(ctypes.POINTER(ty))


def bbox_overlaps(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
    """[N, K] IoU of boxes [N, 4] against query [K, 4] (x1, y1, x2, y2),
    widths and heights + 1, 0 where the boxes do not intersect; float32."""
    boxes = np.ascontiguousarray(boxes, np.float32)
    query = np.ascontiguousarray(query, np.float32)
    bw = boxes[:, 2] - boxes[:, 0] + 1
    bh = boxes[:, 3] - boxes[:, 1] + 1
    qw = query[:, 2] - query[:, 0] + 1
    qh = query[:, 3] - query[:, 1] + 1
    iw = np.clip(np.minimum(boxes[:, None, 2], query[None, :, 2]) -
                 np.maximum(boxes[:, None, 0], query[None, :, 0]) + 1, 0, None)
    ih = np.clip(np.minimum(boxes[:, None, 3], query[None, :, 3]) -
                 np.maximum(boxes[:, None, 1], query[None, :, 1]) + 1, 0, None)
    inter = iw * ih
    union = (bw * bh)[:, None] + (qw * qh)[None, :] - inter
    return np.where(inter > 0, inter / np.maximum(union, 1e-12),
                    0.0).astype(np.float32)


def _overlaps_with(dets, i):
    """IoU (+1 convention) of box i of dets [N, >=4] with every box."""
    area = (dets[:, 2] - dets[:, 0] + 1) * (dets[:, 3] - dets[:, 1] + 1)
    iw = np.clip(np.minimum(dets[i, 2], dets[:, 2]) -
                 np.maximum(dets[i, 0], dets[:, 0]) + 1, 0, None)
    ih = np.clip(np.minimum(dets[i, 3], dets[:, 3]) -
                 np.maximum(dets[i, 1], dets[:, 1]) + 1, 0, None)
    inter = iw * ih
    return inter / (area[i] + area - inter)


def greedy_nms(dets: np.ndarray, thresh: float) -> np.ndarray:
    """Kept indices in pick order. dets [N, 5] (x1, y1, x2, y2, score)."""
    dets = np.ascontiguousarray(dets, np.float32)
    lib = _load()
    if lib:
        keep = np.empty(len(dets), np.int64)
        n = lib.greedy_nms(_ptr(dets, ctypes.c_float), len(dets), thresh,
                           _ptr(keep, ctypes.c_int64))
        return keep[:n]
    order = dets[:, 4].argsort(kind="stable")[::-1]
    keep, sup = [], np.zeros(len(dets), bool)
    for i in order:
        if sup[i]:
            continue
        keep.append(i)
        sup |= _overlaps_with(dets, i) > thresh
        sup[i] = True
    return np.asarray(keep, np.int64)


def soft_nms(dets: np.ndarray, sigma: float, max_dets: int = -1):
    """Gaussian soft-NMS: (kept indices, decayed scores)."""
    dets = np.ascontiguousarray(dets, np.float32)
    lib = _load()
    cap = len(dets) if max_dets < 0 else min(max_dets, len(dets))
    if lib:
        keep = np.empty(cap, np.int64)
        sc = np.empty(cap, np.float32)
        n = lib.soft_nms(_ptr(dets, ctypes.c_float), len(dets), sigma, cap,
                         _ptr(keep, ctypes.c_int64), _ptr(sc, ctypes.c_float))
        return keep[:n], sc[:n]
    score = dets[:, 4].copy()
    dead = np.zeros(len(dets), bool)
    keep, scores = [], []
    while len(keep) < cap:
        live = np.where(~dead)[0]
        if not len(live):
            break
        i = live[score[live].argmax()]
        keep.append(i)
        scores.append(score[i])
        dead[i] = True
        ov = _overlaps_with(dets, i)
        score[~dead] *= np.exp(-(ov[~dead] ** 2) / sigma)
    return np.asarray(keep, np.int64), np.asarray(scores, np.float32)


def coco_match_image(ious: np.ndarray, gt_area: np.ndarray,
                     gt_crowd: np.ndarray, det_area: np.ndarray,
                     thrs: np.ndarray, area_rng: np.ndarray):
    """Greedy COCO matching of one (image, class) over every area range and
    IoU threshold in one native call (cocoeval.evaluateImg semantics).
    Returns (matched [A, T, D] bool, ignored [A, T, D] bool, num_gt [A]
    int64), or None where the library is not built: the caller
    (data/eval.py) then runs its pure-Python matcher."""
    lib = _load()
    if not lib:
        return None
    D, G = ious.shape
    A, T = len(area_rng), len(thrs)
    ious = np.require(ious, np.float64, "C")
    gt_area = np.require(gt_area, np.float64, "C")
    gt_crowd = np.require(gt_crowd, np.uint8, "C")
    det_area = np.require(det_area, np.float64, "C")
    thrs = np.require(thrs, np.float64, "C")
    area_rng = np.require(area_rng, np.float64, "C")
    matched = np.empty((A, T, D), np.uint8)
    ignored = np.empty((A, T, D), np.uint8)
    num_gt = np.empty((A,), np.int64)
    lib.coco_match_image(ious.ctypes.data, D, G, gt_area.ctypes.data,
                         gt_crowd.ctypes.data, det_area.ctypes.data,
                         thrs.ctypes.data, T, area_rng.ctypes.data, A,
                         matched.ctypes.data, ignored.ctypes.data,
                         num_gt.ctypes.data)
    return matched.view(bool), ignored.view(bool), num_gt


def rle_encode(mask: np.ndarray) -> np.ndarray:
    """COCO RLE counts of a [h, w] binary mask (column-major runs, the
    first run counts zeros)."""
    mask = np.ascontiguousarray(mask.T.reshape(-1), np.uint8)
    lib = _load()
    if lib:
        counts = np.empty(mask.size + 1, np.uint32)
        m = lib.rle_encode(_ptr(mask, ctypes.c_uint8), mask.size, 1,
                           _ptr(counts, ctypes.c_uint32), counts.size)
        return counts[:m].copy()
    bounds = np.concatenate([[0], np.nonzero(np.diff(mask))[0] + 1,
                             [mask.size]])
    counts = np.diff(bounds)
    if mask[0] == 1:
        counts = np.concatenate([[0], counts])
    return counts.astype(np.uint32)


def rle_decode(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    """[h, w] uint8 mask of RLE counts."""
    counts = np.ascontiguousarray(counts, np.uint32)
    lib = _load()
    if lib:
        out = np.empty(h * w, np.uint8)
        lib.rle_decode(_ptr(counts, ctypes.c_uint32), len(counts), h, w,
                       _ptr(out, ctypes.c_uint8))
        return out.reshape(w, h).T
    flat = np.zeros(h * w, np.uint8)
    pos, v = 0, 0
    for c in counts:
        flat[pos:pos + int(c)] = v
        pos += int(c)
        v = 1 - v
    return flat.reshape(w, h).T


def rle_iou(counts_a: np.ndarray, counts_b: np.ndarray,
            iscrowd: bool = False) -> float:
    """IoU of two RLE masks of one size; for a crowd b, intersection over
    the area of a."""
    a = np.ascontiguousarray(counts_a, np.uint32)
    b = np.ascontiguousarray(counts_b, np.uint32)
    lib = _load()
    if lib:
        return float(lib.rle_iou(_ptr(a, ctypes.c_uint32), len(a),
                                 _ptr(b, ctypes.c_uint32), len(b),
                                 int(iscrowd)))
    n = int(a.sum())
    ma = rle_decode(a, n, 1).reshape(-1).astype(bool)
    mb = rle_decode(b, n, 1).reshape(-1).astype(bool)
    inter = float(np.sum(ma & mb))
    denom = float(np.sum(ma)) if iscrowd else float(np.sum(ma | mb))
    return inter / denom if denom else 0.0
