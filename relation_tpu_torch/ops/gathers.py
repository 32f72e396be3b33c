"""Row gathers of the learned-NMS head (port of relation_tpu/ops/gathers.py).

The JAX package gives these a custom VJP, a one-hot matmul in place of the
scatter-add that serialises on the TPU. On the GPU the plain gather and its
scatter-add backward are the direct form, so these are thin names over
``index_select`` / ``gather`` and autograd differentiates them.
"""

from __future__ import annotations

import torch


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [N, D], idx [...] int -> x[idx] [..., D]."""
    return x.index_select(0, idx.reshape(-1)).reshape(idx.shape + x.shape[1:])


def take_along0(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis(x [N, C], idx [F, C], axis=0) -> [F, C]."""
    return torch.gather(x, 0, idx)
