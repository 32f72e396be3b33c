"""Exact greedy NMS and soft-NMS on the device (port of
relation_tpu/ops/nms.py).

``nms_topk_presorted`` is the proposal path and ``classwise_nms`` the classic
detection tail: their keep masks come from
ops/kernels/nms_kernel.py::nms_keep_sorted (the CUDA kernel for CUDA tensors,
its plain blocked fixpoint on the CPU), one call over every class.
``greedy_nms_mask`` is the unsorted form with an IoU-division test, kept as
the general oracle, and ``greedy_nms_topk`` its padded top-k. ``soft_nms`` is
plain PyTorch, batched over classes. Sorts are stable, as ``jnp.argsort``
is, so ties break the same way as in the JAX package.
"""

from __future__ import annotations

import torch

from relation_tpu_torch.ops.boxes import bbox_overlaps
from relation_tpu_torch.ops.kernels.nms_kernel import nms_keep_sorted
from relation_tpu_torch.utils import trace

_NEG_INF = -1e10


def _argsort_desc(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Stable descending argsort: jnp.argsort(-x)."""
    return torch.argsort(-x, dim=dim, stable=True)


def _intra_block_fixpoint(iou_gt: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Greedy keep mask inside one block: iterate
    active_j = seed_j & ~any_{i<j}(active_i & iou_gt[i, j]) to its fixpoint."""
    B = seed.shape[0]
    sup = iou_gt & torch.triu(torch.ones((B, B), dtype=torch.bool,
                                         device=seed.device), diagonal=1)
    active = seed
    for _ in range(B):
        nxt = seed & ~(active[:, None] & sup).any(0)
        if torch.equal(nxt, active):
            break
        active = nxt
    return active


def greedy_nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
                    valid: torch.Tensor | None = None, block_size: int = 512,
                    max_keep: int | None = None) -> torch.Tensor:
    """Exact greedy NMS; bool keep mask in the input order. Semantics of the
    reference host NMS (lib/nms/nms.py:45-83): descending score, +1 IoU,
    suppression only by earlier kept boxes; ``max_keep`` stops the block
    sweep once that many are kept (exact for the top-max_keep kept set)."""
    n = boxes.shape[0]
    dev = boxes.device
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    order = _argsort_desc(torch.where(valid, scores,
                                      torch.full_like(scores, _NEG_INF)))
    B = min(block_size, n)
    np_pad = -(-n // B) * B
    boxes_s = torch.zeros((np_pad, 4), dtype=boxes.dtype, device=dev)
    boxes_s[:n] = boxes[order]
    valid_s = torch.zeros((np_pad,), dtype=torch.bool, device=dev)
    valid_s[:n] = valid[order]
    keep_s = torch.zeros((np_pad,), dtype=torch.bool, device=dev)
    col = torch.arange(np_pad, device=dev)
    cap = np_pad if max_keep is None else int(max_keep)
    kept = 0
    for lo in range(0, np_pad, B):
        if kept >= cap:
            break
        blk = boxes_s[lo:lo + B]
        iou_all = bbox_overlaps(blk, boxes_s)
        sup_prev = ((iou_all > iou_thresh) & keep_s[None, :]
                    & (col[None, :] < lo)).any(1)
        seed = valid_s[lo:lo + B] & ~sup_prev
        active = _intra_block_fixpoint(bbox_overlaps(blk, blk) > iou_thresh, seed)
        keep_s[lo:lo + B] = active
        trace.count("host_read.nms_kept")
        kept += int(active.sum())
    keep = torch.zeros((n,), dtype=torch.bool, device=dev)
    keep[order] = keep_s[:n]
    return keep


def nms_topk_presorted(boxesT: torch.Tensor, scores: torch.Tensor,
                       valid: torch.Tensor, iou_thresh: float, top_k: int):
    """Greedy NMS over boxes ALREADY in descending-score order, planar
    [4, N]; then the top_k kept boxes in score order, padded by cycling
    through the kept boxes (relation_tpu/ops/nms.py:200-206).
    Returns (indices [top_k] into the sorted input, real [top_k] bool)."""
    n = boxesT.shape[1]
    dev = boxesT.device
    T = 256 if n >= 256 else 128
    np_pad = -(-n // T) * T
    bTp = torch.zeros((1, 4, np_pad), dtype=torch.float32, device=dev)
    bTp[0, :, :n] = boxesT
    vp = torch.zeros((1, np_pad), dtype=torch.float32, device=dev)
    vp[0, :n] = valid.to(torch.float32)
    keep = nms_keep_sorted(bTp, vp, float(iou_thresh), block=T,
                           max_keep=int(top_k))[0, :n] > 0.5
    order = _argsort_desc(torch.where(keep, scores,
                                      torch.full_like(scores, _NEG_INF)))
    num_keep = keep.sum()
    slots = torch.arange(top_k, device=dev)
    real = slots < num_keep
    idx = torch.where(real, slots, slots % torch.clamp_min(num_keep, 1))
    return order[idx], real


def greedy_nms_topk(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
                    top_k: int, valid: torch.Tensor | None = None,
                    block_size: int = 512):
    """Greedy NMS of unsorted boxes [N, 4], then the top_k kept boxes in
    score order, padded by cycling through the kept boxes. Returns
    (indices [top_k] into the input, real [top_k] bool: not a repeat)."""
    keep = greedy_nms_mask(boxes, scores, iou_thresh, valid, block_size,
                           max_keep=top_k)
    order = _argsort_desc(torch.where(keep, scores,
                                      torch.full_like(scores, _NEG_INF)))
    num_keep = keep.sum()
    slots = torch.arange(top_k, device=boxes.device)
    real = slots < num_keep
    idx = torch.where(real, slots, slots % torch.clamp_min(num_keep, 1))
    return order[idx], real


def soft_nms(boxes: torch.Tensor, scores: torch.Tensor, sigma: float,
             max_dets: int, valid: torch.Tensor | None = None,
             score_floor: float = 0.0):
    """Gaussian soft-NMS with a fixed number of iterations: each one picks
    the highest live score (the first index among ties, as ``argmax``),
    records it, and multiplies the other live scores by exp(-iou^2 / sigma).

    boxes [N, 4] with scores [N], or batched over classes: boxes [C, N, 4],
    scores [C, N]. Returns (keep_idx [.., max_dets], keep_scores
    [.., max_dets], keep_valid [.., max_dets] bool: score above the floor)."""
    single = scores.dim() == 1
    if single:
        boxes, scores = boxes[None], scores[None]
        valid = None if valid is None else valid[None]
    C, n = scores.shape
    dev = scores.device
    neg = torch.full_like(scores, _NEG_INF)
    live = scores if valid is None else torch.where(valid, scores, neg)
    rows = torch.arange(C, device=dev)
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    idx = torch.empty((C, max_dets), dtype=torch.long, device=dev)
    kept = torch.empty((C, max_dets), dtype=scores.dtype, device=dev)
    for it in range(max_dets):
        # torch.max(dim) does not promise the first index among ties on
        # every device; the first index of the maximum does
        top = live.max(dim=1, keepdim=True).values
        i = (live == top).to(torch.int8).argmax(dim=1)
        idx[:, it], kept[:, it] = i, top[:, 0]
        bx1, by1, bx2, by2 = (c[rows, i, None] for c in (x1, y1, x2, y2))
        iw = (torch.minimum(bx2, x2) - torch.maximum(bx1, x1) + 1.0).clamp_min(0)
        ih = (torch.minimum(by2, y2) - torch.maximum(by1, y1) + 1.0).clamp_min(0)
        inter = iw * ih
        iou = torch.where(inter > 0, inter / (area[rows, i, None] + area - inter),
                          torch.zeros_like(inter))          # ops/boxes.py form
        decay = torch.exp(-(iou * iou) / sigma)
        live = live * torch.where(live > _NEG_INF / 2, decay,
                                  torch.ones_like(decay))
        live[rows, i] = _NEG_INF
    keep_valid = kept > score_floor
    if single:
        return idx[0], kept[0], keep_valid[0]
    return idx, kept, keep_valid


def classwise_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
                  score_thresh: float, valid: torch.Tensor | None = None,
                  max_keep: int | None = None) -> torch.Tensor:
    """Per-class greedy NMS keep mask, bool [C, N], in the input order.

    boxes [C, N, 4] (or [N, 4] shared by the classes), scores [C, N]. One
    route on every device, the JAX package's TPU route: stable descending
    sort per class, pad to a multiple of the sweep block, ONE call of
    ``nms_keep_sorted`` over [C, 4, Np] (the CUDA kernel walks each class
    with its own cluster of blocks, each stopping at its own ``max_keep``),
    un-sort."""
    C, n = scores.shape
    dev = scores.device
    if boxes.dim() == 2:
        boxes = boxes[None].expand(C, n, 4)
    ok = scores > score_thresh
    valid = ok if valid is None else valid & ok
    order = _argsort_desc(torch.where(valid, scores,
                                      torch.full_like(scores, _NEG_INF)), dim=1)
    boxes_s = torch.gather(boxes, 1, order[..., None].expand(C, n, 4))
    valid_s = torch.gather(valid, 1, order)
    T = 256 if n >= 256 else 128
    np_pad = -(-n // T) * T
    bT = torch.zeros((C, 4, np_pad), dtype=torch.float32, device=dev)
    bT[:, :, :n] = boxes_s.to(torch.float32).transpose(1, 2)
    vf = torch.zeros((C, np_pad), dtype=torch.float32, device=dev)
    vf[:, :n] = valid_s.to(torch.float32)
    cap = np_pad if max_keep is None else int(max_keep)
    keep_s = nms_keep_sorted(bT, vf, float(iou_thresh), block=T,
                             max_keep=cap)[:, :n] > 0.5
    keep = torch.zeros_like(keep_s)
    keep.scatter_(1, order, keep_s)
    return keep
