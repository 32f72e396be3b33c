"""Geometric / rank sinusoid embeddings and pairwise position matrices
(port of relation_tpu/ops/embeddings.py). Constants are load-bearing: the 100x
position scale, wave length 1000 and the 1e-3 clamps."""

from __future__ import annotations

import torch


def _sinusoid(x: torch.Tensor, feat_dim: int, num_fields: int,
              wave_length: float = 1000.0) -> torch.Tensor:
    """x: [..., num_fields] -> [..., feat_dim]; per field sin block then cos block."""
    per = feat_dim // (2 * num_fields)
    feat_range = torch.arange(per, dtype=torch.float32, device=x.device)
    # filled on the device: a tensor made from the host value would be a
    # blocking copy to the card
    base = torch.full((), wave_length, dtype=torch.float32, device=x.device)
    dim_mat = torch.pow(base, (2.0 * num_fields / feat_dim) * feat_range)
    div = x[..., None] / dim_mat
    emb = torch.cat([torch.sin(div), torch.cos(div)], dim=-1)
    return emb.reshape(x.shape[:-1] + (feat_dim,))


def _pairwise_geometry(b: torch.Tensor) -> torch.Tensor:
    """b: [..., N, 4] -> [..., 4, N, N] field-major (dx, dy, dw, dh)."""
    xmin, ymin, xmax, ymax = b.unbind(-1)
    # degenerate-box guard (relation_tpu/ops/embeddings.py:42-47)
    w = torch.clamp_min(xmax - xmin + 1.0, 1e-3)
    h = torch.clamp_min(ymax - ymin + 1.0, 1e-3)
    cx = 0.5 * (xmin + xmax)
    cy = 0.5 * (ymin + ymax)
    dx = (cx[..., :, None] - cx[..., None, :]) / w[..., :, None]
    dx = torch.log(torch.clamp_min(torch.abs(dx), 1e-3))
    dy = (cy[..., :, None] - cy[..., None, :]) / h[..., :, None]
    dy = torch.log(torch.clamp_min(torch.abs(dy), 1e-3))
    dw = torch.log(w[..., :, None] / w[..., None, :])
    dh = torch.log(h[..., :, None] / h[..., None, :])
    return torch.stack([dx, dy, dw, dh], dim=-3)


def extract_position_matrix_t(bbox: torch.Tensor, nongt_dim: int) -> torch.Tensor:
    """Field-major pairwise geometry of the relation module: [N, 4] ->
    [4, N, nongt_dim] (reference symbols/..._learn_nms.py:52-88)."""
    return _pairwise_geometry(bbox)[:, :, :nongt_dim]


def extract_multi_position_matrix_t(bbox: torch.Tensor) -> torch.Tensor:
    """Per-class pairwise geometry of the learned-NMS attention:
    [N, C, 4] -> [C, 4, N, N] (reference ...learn_nms_base.py:249-289)."""
    return _pairwise_geometry(bbox.transpose(0, 1))


def extract_rank_embedding(rank_dim: int, feat_dim: int,
                           wave_length: float = 1000.0,
                           device=None) -> torch.Tensor:
    """Sinusoid over the integer rank -> [rank_dim, feat_dim] (reference
    ...learn_nms_base.py:166-187: one field, no 100x scale)."""
    rank = torch.arange(rank_dim, dtype=torch.float32, device=device)
    return _sinusoid(rank[:, None], feat_dim, num_fields=1,
                     wave_length=wave_length)
