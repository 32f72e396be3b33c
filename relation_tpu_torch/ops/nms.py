"""Exact greedy NMS on the device (port of relation_tpu/ops/nms.py).

``nms_topk_presorted`` is the proposal path: its keep mask comes from
ops/kernels/nms_kernel.py::nms_keep_sorted (the CUDA kernel for CUDA tensors,
its plain blocked fixpoint on the CPU). ``greedy_nms_mask`` is the unsorted
form with an IoU-division test, kept as the general oracle. Sorts are stable,
as ``jnp.argsort`` is, so ties break the same way as in the JAX package.
"""

from __future__ import annotations

import torch

from relation_tpu_torch.ops.boxes import bbox_overlaps
from relation_tpu_torch.ops.kernels.nms_kernel import nms_keep_sorted

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
