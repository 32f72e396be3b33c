"""Learned NMS ("duplicate removal") head (port of
relation_tpu/models/learn_nms.py; reference symbols/..._learn_nms.py:412-551
and operator_py/learn_nms.py:219-405).

The per-class rank gathers are direct gathers here (ops/gathers.py): the JAX
package's one-hot contractions are a TPU form of the same exact selection,
forward and backward.

Gradient flow as in the reference: bbox_pred is blocked before refine_bbox
(:428); sorted_score is not (:499-501), so the loss reaches the classifier
through the multiplicative score fusion.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from relation_tpu_torch.models.relation import Dense, NMSRelationModule
from relation_tpu_torch.ops.boxes import refine_bbox
from relation_tpu_torch.ops.gathers import take_along0, take_rows
from relation_tpu_torch.ops.embeddings import (extract_multi_position_matrix_t,
                                               extract_rank_embedding)


class LearnNMSHead(nn.Module):
    """forward(cls_score [N, K], bbox_pred [N, 4*num_reg], rois [N, 4],
    roi_feat [N, D], im_info [3], class_thresh, allow_pallas, probe) -> dict
    with nms_multi_score [F, C, T], sorted_bbox [F, C, 4], sorted_score
    [F, C], nms_conditional_score [F, C, T] (F = first_n, C = fg classes)."""

    PROBES = ("", "embed", "attn")

    def __init__(self, num_fg_classes: int, first_n: int, num_thresh: int,
                 roi_feat_dim: int, class_agnostic: bool = True,
                 bbox_means=None, bbox_stds=None,
                 attn_dtype: torch.dtype = torch.float32,
                 allow_pallas: bool = True, compact_classes: int = 32):
        super().__init__()
        self.num_fg_classes, self.first_n = num_fg_classes, first_n
        self.class_agnostic = class_agnostic
        self.bbox_means, self.bbox_stds = bbox_means, bbox_stds
        self.nms_rank = Dense(1024, 128)
        self.roi_feat_embedding = Dense(roi_feat_dim, 128)
        self.NMSRelationModule_0 = NMSRelationModule(
            index=1, feat_dim=128, dim_qk=1024, dim_out=128, groups=16,
            dtype=attn_dtype, allow_pallas=allow_pallas,
            compact_classes=compact_classes)
        self.nms_logit = Dense(128, num_thresh)
        self.num_thresh = num_thresh

    def forward(self, cls_score, bbox_pred, rois, roi_feat, im_info,
                class_thresh: float = 0.0, allow_pallas: bool | None = None,
                probe: str = ""):
        """``allow_pallas`` overrides the attention's branch for this call
        (NMSRelationModule). ``probe`` is a benchmarking cut inside the head
        (the train step's lnms_embed / lnms_attn): 'embed' stops after the
        rank and ROI embeddings and the position matrix, 'attn' after
        relu(embedding + attention); both return the same dict, with the
        conditional score z = zeros [F, C, T] + 1e-30 x the sum of the cut
        point's tensors and nms_multi_score = sorted_score + z."""
        if probe not in self.PROBES:
            raise ValueError(f"probe={probe!r}: one of {self.PROBES}")
        C, F_ = self.num_fg_classes, self.first_n
        refined = refine_bbox(rois, bbox_pred.detach()[:, 4:],
                              im_hw=(im_info[0], im_info[1]),
                              means=self.bbox_means, stds=self.bbox_stds)
        prob_nobg = torch.softmax(cls_score, dim=-1)[:, 1:]       # [N, C]
        # stable descending sort per class (jnp.argsort(-p, axis=0))
        rank_idx = torch.argsort(-prob_nobg, dim=0, stable=True)[:F_]  # [F, C]
        sorted_score = take_along0(prob_nobg, rank_idx)
        if self.class_agnostic:
            sorted_bbox = take_rows(refined[:, :, 0], rank_idx)   # [F, C, 4]
        else:
            refined_cls = refined.permute(0, 2, 1)[:, :C, :]      # [N, C, 4]
            sorted_bbox = refined_cls[rank_idx, torch.arange(
                C, device=rank_idx.device)[None, :]]

        rank_feat = self.nms_rank(extract_rank_embedding(
            F_, 1024, device=cls_score.device))                   # [F, 128]
        pos_t = extract_multi_position_matrix_t(sorted_bbox)      # [C,4,F,F]
        roi_emb = self.roi_feat_embedding(roi_feat).float()       # [N, 128]
        emb = take_rows(roi_emb, rank_idx) + rank_feat[:, None, :]  # [F, C, 128]
        if probe == "embed":
            return self._probe_out(
                sorted_score, sorted_bbox,
                1e-30 * (torch.sum(emb) + torch.sum(pos_t)))

        # inference valid-class filter (reference learn_nms.py:296-309)
        active = None
        if class_thresh > 0.0:
            max_per_class = sorted_score.max(dim=0).values        # [C]
            thr = torch.clamp_max(max_per_class.max(), class_thresh)
            active = max_per_class >= thr

        attention = self.NMSRelationModule_0(
            emb, pos_t, None if active is None else active.to(torch.int32),
            allow_pallas)
        feat = torch.relu(emb + attention)
        if probe == "attn":
            return self._probe_out(sorted_score, sorted_bbox,
                                   1e-30 * torch.sum(feat))
        conditional = torch.sigmoid(self.nms_logit(feat))         # [F, C, T]
        if active is not None:
            # where(), not multiply: skipped classes' rows are unwritten
            # memory and may hold NaN
            conditional = torch.where(active[None, :, None], conditional,
                                      torch.zeros_like(conditional))
        return {"nms_multi_score": sorted_score[..., None] * conditional,
                "sorted_bbox": sorted_bbox, "sorted_score": sorted_score,
                "nms_conditional_score": conditional}

    def _probe_out(self, sorted_score, sorted_bbox, tap):
        """The head's dict at a probe: the uncut tail replaced by ``tap``,
        the 1e-30 projection of the cut point."""
        z = sorted_score.new_zeros(sorted_score.shape + (self.num_thresh,)) + tap
        return {"nms_multi_score": sorted_score[..., None] + z,
                "sorted_bbox": sorted_bbox, "sorted_score": sorted_score,
                "nms_conditional_score": z}


def merge_multi_score(nms_multi_score: torch.Tensor, merge_method: int):
    """Merge over the threshold axis (reference :553-562):
    -1 mean, -2 max, 0 <= i < T pick index i."""
    if merge_method == -1:
        return nms_multi_score.mean(dim=2)
    if merge_method == -2:
        return nms_multi_score.max(dim=2).values
    if 0 <= merge_method < nms_multi_score.shape[2]:
        return nms_multi_score[:, :, merge_method]
    raise NotImplementedError(f"Unknown merge method {merge_method}.")
