"""Host-side box helpers (port of relation_tpu/utils/native.py). Only
``bbox_overlaps`` is here so far, in NumPy: the JAX package's fallback
when its native library is not built, with the reference's +1 convention."""

from __future__ import annotations

import numpy as np


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
