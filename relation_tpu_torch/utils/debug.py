"""Tensor monitoring (port of relation_tpu/utils/debug.py; the reference's
``monitor`` CustomOp, operator_py/monitor_op.py:16-53, an identity that
names a tensor and prints its summary mid-graph)."""

from __future__ import annotations

import torch


def monitor(x: torch.Tensor, nickname: str = "tensor",
            stats: bool = True) -> torch.Tensor:
    """Identity that prints ``x``'s shape and, with ``stats``, its min, max
    and mean (a synchronising read on the card). Autograd passes through."""
    if stats:
        mn, mx, me = tensor_stats(x.detach()).tolist()
        print(f"[monitor] {nickname} shape={tuple(x.shape)} min={mn:.5f} "
              f"max={mx:.5f} mean={me:.5f}")
    else:
        print(f"[monitor] {nickname} shape={tuple(x.shape)}")
    return x


def tensor_stats(x: torch.Tensor) -> torch.Tensor:
    """[min, max, mean] of ``x`` as one f32 triple on its device: the tap
    the predictor returns under TPU.DEBUG_MONITOR (``out["monitor"]``),
    read by the evaluator."""
    xf = x.detach().float()
    return torch.stack([xf.min(), xf.max(), xf.mean()])
