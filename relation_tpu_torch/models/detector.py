"""Faster R-CNN (ResNet-101 C4 + dilated C5) with relation modules and the
learned-NMS head, plain or DCN (deformable res5 + deformable PSROI head);
port of relation_tpu/models/detector.py.

Public methods keep the JAX package's layouts so the tests compare like
with like: ``features_and_rpn`` returns [h, w, 256] features and
[h, w, A, 2] / [h, w, A, 4] RPN outputs. Inside, the trunk is NCHW.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from relation_tpu_torch.models.backbone import (Conv2d, ResNet101C4,
                                                ResNet101C5, ResNet101C5DCN)
from relation_tpu_torch.models.learn_nms import LearnNMSHead
from relation_tpu_torch.models.relation import Dense, RelationModule
from relation_tpu_torch.models.rpn import RPNHead
from relation_tpu_torch.ops.deform import deformable_psroi_pool
from relation_tpu_torch.ops.embeddings import extract_position_matrix_t
from relation_tpu_torch.ops.kernels.roi_align import roi_align_levels
from relation_tpu_torch.ops.roi_pool import roi_pool


class RelationRCNN(nn.Module):
    """The detector; the arguments mirror the flax module's fields."""

    def __init__(self, num_classes: int = 81, num_anchors: int = 12,
                 class_agnostic: bool = True, use_relation: bool = True,
                 use_learn_nms: bool = True, first_n: int = 100,
                 num_thresh: int = 5, bbox_means=None, bbox_stds=None,
                 backbone: str = "resnet101", head_dim: int = 1024,
                 rcnn_feat_stride: int = 16,
                 conv_dtype: torch.dtype = torch.bfloat16,
                 head_dtype: torch.dtype = torch.float32,
                 freeze_through: int = 0, dcn: bool = False,
                 dcn_pool_dtype: torch.dtype = torch.float32,
                 lnms_allow_pallas: bool = True, compact_classes: int = 32,
                 roi_method: str = "align"):
        """``dcn``: deformable res5 and the deformable PSROI head (a no-trans
        pool feeds the zero-initialised ``offset`` FC, whose output steers a
        second pool); ``dcn_pool_dtype`` is the dtype both pools run in.
        ``roi_method`` pools the plain head's ROIs: "align" (ROIAlign,
        ``roi_align_levels`` with one level) or "pool" (exact MXNet
        ROIPooling, ``roi_pool``; TPU.ROI_METHOD).
        ``lnms_allow_pallas`` and ``compact_classes`` pick the learned-NMS
        attention's branch (LearnNMSHead, TPU.LNMS_ATTN and
        TPU.NMS_COMPACT_CLASSES)."""
        super().__init__()
        if roi_method not in ("align", "pool"):
            raise ValueError(f"roi_method {roi_method!r}: 'align' or 'pool'")
        self.backbone = backbone
        self.roi_method = roi_method
        self.dcn, self.dcn_pool_dtype = dcn, dcn_pool_dtype
        self.conv_dtype = conv_dtype
        self.use_relation, self.use_learn_nms = use_relation, use_learn_nms
        self.rcnn_feat_stride = rcnn_feat_stride
        if backbone == "resnet101":
            self.c4 = ResNet101C4(dtype=conv_dtype,
                                  freeze_through=freeze_through)
            self.c5 = ResNet101C5DCN() if dcn else ResNet101C5()
            c4_ch, c5_ch = 1024, 2048
        else:
            self.c4 = _TinyTrunk()
            self.c5 = None                   # the tiny trunk has no res5
            c4_ch = c5_ch = 32
        self.rpn = RPNHead(c4_ch, num_anchors)
        self.conv_new_1 = Conv2d(c5_ch, 256, 1)
        if dcn:
            self.offset = Dense(7 * 7 * 256, 7 * 7 * 2)
        self.fc_new_1 = Dense(7 * 7 * 256, head_dim, head_dtype)
        self.fc_new_2 = Dense(head_dim, head_dim, head_dtype)
        if use_relation:
            self.relation_1 = RelationModule(1, head_dim, head_dim, head_dim,
                                             dtype=head_dtype)
            self.relation_2 = RelationModule(2, head_dim, head_dim, head_dim,
                                             dtype=head_dtype)
        self.cls_score = Dense(head_dim, num_classes)
        num_reg = 2 if class_agnostic else num_classes
        self.bbox_pred = Dense(head_dim, 4 * num_reg)
        if use_learn_nms:
            self.learn_nms_head = LearnNMSHead(
                num_classes - 1, first_n, num_thresh, head_dim,
                class_agnostic=class_agnostic, bbox_means=bbox_means,
                bbox_stds=bbox_stds, attn_dtype=head_dtype,
                allow_pallas=lnms_allow_pallas, compact_classes=compact_classes)

    def features_and_rpn(self, image: torch.Tensor, res4_folded=None):
        """image [H, W, 3] or s2d [12, H/2, W/2] (mean-subtracted BGR); a 4D
        input is an explicit batch. -> (head_feat [(B,) h, w, 256],
        rpn_cls [(B,) h, w, A, 2], rpn_bbox [(B,) h, w, A, 4]).
        ``res4_folded`` (backbone.fold_res4_params) runs res4b1..b22 of a
        single image as the fused stack kernel."""
        batched = image.dim() == 4
        x = image if batched else image[None]
        if self.backbone == "resnet101":
            c4 = self.c4(x, res4_folded)                       # NCHW
        else:
            c4 = self.c4(x)
        rpn_cls, rpn_bbox = self.rpn(c4)
        c5 = c4 if self.c5 is None else self.c5(c4)
        reduced = F.relu(self.conv_new_1(c5)).permute(0, 2, 3, 1)
        if batched:
            return reduced, rpn_cls, rpn_bbox
        return reduced[0], rpn_cls[0], rpn_bbox[0]

    def head(self, reduced_feat, rois, nongt_dim: int, pool_only: bool = False):
        """ROI head: feat [h, w, 256], rois [N, 4] -> (cls_score [N, K],
        bbox_pred [N, 4*num_reg], fc_all_2_relu [N, D]). ``pool_only``
        returns the flattened pooled features [N, 7*7*256] f32 (the train
        step's stop_after='pool' cut)."""
        scale = 1.0 / self.rcnn_feat_stride
        if self.dcn:
            pf = reduced_feat.to(self.dcn_pool_dtype)
            offset_t = deformable_psroi_pool(pf, rois, None, scale,
                                             pooled_size=7, sample_per_part=4)
            off = self.offset(offset_t.reshape(rois.shape[0], -1).float())
            pooled = deformable_psroi_pool(pf, rois, off.reshape(-1, 2, 7, 7),
                                           scale, pooled_size=7,
                                           sample_per_part=4, trans_std=0.1)
        elif self.roi_method == "pool":
            pooled = roi_pool(reduced_feat, rois, scale, 7)
        else:
            pooled = roi_align_levels([reduced_feat], [scale], rois, 7)
        flat = pooled.reshape(pooled.shape[0], -1).float()
        if pool_only:
            return flat
        if self.use_relation:
            pos_t = extract_position_matrix_t(rois, nongt_dim)
        x = self.fc_new_1(flat)
        if self.use_relation:
            x = x + self.relation_1(x, pos_t)
        x = self.fc_new_2(F.relu(x))
        if self.use_relation:
            x = x + self.relation_2(x, pos_t)
        fc2 = F.relu(x)
        return self.cls_score(fc2), self.bbox_pred(fc2), fc2

    def learn_nms(self, cls_score, bbox_pred, rois, roi_feat, im_info,
                  class_thresh: float = 0.0, probe: str = ""):
        return self.learn_nms_head(cls_score, bbox_pred, rois, roi_feat,
                                   im_info, class_thresh, probe=probe)


class _TinyTrunk(nn.Module):
    """Stride-16 toy trunk of the tests: four 3x3/2 convs with flax 'SAME'
    padding (asymmetric at stride 2). Accepts NHWC or s2d planar input."""

    def __init__(self):
        super().__init__()
        for i in range(4):
            setattr(self, f"tiny{i}", Conv2d(3 if i == 0 else 32, 32, 3,
                                             stride=2))

    def forward(self, x):
        if x.dim() == 4 and x.shape[1] == 12:
            B, K, Ho, Wo = x.shape
            x = (x.reshape(B, 2, 2, 3, Ho, Wo).permute(0, 4, 1, 5, 2, 3)
                 .reshape(B, 2 * Ho, 2 * Wo, 3))
        x = x.permute(0, 3, 1, 2)
        for i in range(4):
            h, w = x.shape[-2:]
            ph = max((-(-h // 2) - 1) * 2 + 3 - h, 0)
            pw = max((-(-w // 2) - 1) * 2 + 3 - w, 0)
            x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
            x = F.relu(getattr(self, f"tiny{i}")(x))
        return x
