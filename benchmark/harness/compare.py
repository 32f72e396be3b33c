"""The comparisons that judge the program's outputs against the reference's:
detections matched box by box, and the norms of a training step's leaves.
They are the same whatever the configuration, and no reference holds them.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _iou(a, b):
    """IoU matrix of [N, 4] and [M, 4] boxes, +1 widths."""
    ix1 = torch.maximum(a[:, None, 0], b[None, :, 0])
    iy1 = torch.maximum(a[:, None, 1], b[None, :, 1])
    ix2 = torch.minimum(a[:, None, 2], b[None, :, 2])
    iy2 = torch.minimum(a[:, None, 3], b[None, :, 3])
    inter = (ix2 - ix1 + 1).clamp(min=0) * (iy2 - iy1 + 1).clamp(min=0)
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    union = area_a[:, None] + area_b[None, :] - inter
    return torch.where(inter > 0, inter / union, torch.zeros_like(inter))


def dets_gap(prog, ref, top: int, box_tol: float = 0.01):
    """A request's first ``top`` detections against the reference's: each
    is matched to the same-class reference detection, among those within
    IoU 1 - ``box_tol`` of it, whose score is nearest (duplicate boxes of
    one class, as the learned-NMS head scores at several ranks, make the
    box alone ambiguous). Returns (detections compared, detections with no
    such reference detection, the largest absolute score difference of the
    others, the sum of their squared score differences, the sum of their
    squared reference scores). When the counts of real detections differ,
    every detection compared is unmatched."""
    real_p = prog[:, 0] >= 0
    real_r = ref[:, 0] >= 0
    n = min(top, int(real_p.sum()))
    if int(real_p.sum()) != int(real_r.sum()):
        return max(n, 1), max(n, 1), 0.0, 0.0, 0.0
    if n == 0:
        return 0, 0, 0.0, 0.0, 0.0
    p, r = prog[:n], ref[real_r]
    near = ((_iou(p[:, 2:6], r[:, 2:6]) >= 1.0 - box_tol)
            & (p[:, None, 0] == r[None, :, 0]))
    dist = torch.where(near, (p[:, None, 1] - r[None, :, 1]).abs(),
                       torch.full((n, r.shape[0]), float("inf")))
    gap, j = dist.min(dim=1)
    matched = torch.isfinite(gap)
    gap = gap[matched]
    widest = float(gap.max()) if gap.numel() else 0.0
    return (n, int((~matched).sum()), widest, float((gap ** 2).sum()),
            float((r[j, 1][matched] ** 2).sum()))


def nongrad_floor(first):
    """Leaves whose reference gradient norm is under a thousandth of the
    median leaf's: moved by weight decay and round-off alone."""
    norms = {k: float(v.norm()) for k, v in first.items()}
    med = float(np.median(list(norms.values())))
    return {k for k, n in norms.items() if n < 1e-3 * med}, norms, med


def leaf_gaps(prog_norms: dict, ref_norms: dict, skip=()) -> dict:
    """{leaf: |‖prog‖ - ‖ref‖| / max(‖ref‖, median leaf ‖ref‖)}."""
    keys = [k for k in ref_norms if k not in skip]
    med = float(np.median([ref_norms[k] for k in keys])) if keys else 0.0
    return {k: abs(prog_norms[k] - ref_norms[k]) / max(ref_norms[k], med, 1e-30)
            for k in keys}


def worst_leaf_gap(prog_norms: dict, ref_norms: dict, skip=()):
    """(the worst leaf's gap, its name) of ``leaf_gaps``."""
    gaps = leaf_gaps(prog_norms, ref_norms, skip)
    at = max(gaps, key=gaps.get) if gaps else ""
    return (gaps[at] if at else 0.0), at


def median_leaf_gap(prog_norms: dict, ref_norms: dict, skip=()) -> float:
    """The median over leaves of ``leaf_gaps``."""
    gaps = list(leaf_gaps(prog_norms, ref_norms, skip).values())
    return float(np.median(gaps)) if gaps else 0.0


def math_rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12) if math.isfinite(a) else float("inf")
