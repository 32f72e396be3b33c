"""FPN detector: ResNet-101 pyramid trunk, FPN neck, the RPN shared over five
levels, ROI level dispatch and the 2FC head (+relation, +learned NMS); port
of relation_tpu/models/fpn.py (reference symbols/resnet_v1_101_rcnn_fpn*.py).

- neck: lateral 1x1 (256) on res2c / res3b3 / res4b22 / res5c, nearest x2
  top-down sums, 3x3 smooth convs, and P6 a stride-2 3x3 on the ft32
  *lateral* (fpn.py:799-835 of the reference symbol);
- one RPN head (one set of weights) over P6..P2;
- proposals: every level decoded in (a, h, w) order, merged, one exact
  top-k and one NMS;
- ROI dispatch: feat_id = clip(floor(2 + log2(sqrt(w*h)/224)), 0, 3) picks
  stride 4, 8, 16 or 32; each ROI is pooled (7x7 ROIAlign) at its own level
  only (or by exact ROIPooling, ``roi_method='pool'``). The JAX package
  pools every ROI at all four levels and selects with a one-hot
  contraction, a TPU static-shape workaround; the selection is exact, so
  the pooled features are the same (the port's plain version pools at every
  level and selects too; its kernel samples each ROI's own level only).

Public methods keep the JAX package's layouts so the tests compare like with
like: pyramid levels [h, w, 256] and RPN outputs in the raw conv layout
[h, w, 2A] / [h, w, 4A] (channel a*2+j / a*4+j). Inside, NCHW.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from relation_tpu_torch.models.backbone import (Bottleneck, Conv2d, ResNet101C4,
                                                _unit_names)
from relation_tpu_torch.models.learn_nms import LearnNMSHead
from relation_tpu_torch.models.relation import Dense, RelationModule
from relation_tpu_torch.models.rpn import RPNHead, decode_level
from relation_tpu_torch.ops.anchors import generate_anchors, shift_anchors
from relation_tpu_torch.ops.embeddings import extract_position_matrix_t
from relation_tpu_torch.ops.nms import nms_topk_presorted
from relation_tpu_torch.ops.kernels.roi_align import roi_align_levels, roi_levels
from relation_tpu_torch.ops.roi_pool import roi_pool
from relation_tpu_torch.utils import trace

FPN_STRIDES = (64, 32, 16, 8, 4)          # P6..P2, reference output order
DISPATCH_STRIDES = (4, 8, 16, 32)          # rois_0..rois_3
_NEG_INF = -1e10


class ResNet101C5Standard(nn.Module):
    """res5a..res5c with stride 2 and no dilation: res5c sits at stride 32."""

    def __init__(self):
        super().__init__()
        cin = 1024
        for i, name in enumerate(_unit_names(5, 3)):
            setattr(self, f"Bottleneck_{i}", Bottleneck(
                name, cin, 512, 2048, 2 if i == 0 else 1, dilation=1,
                has_proj=(i == 0)))
            cin = 2048

    def forward(self, x):
        for i in range(3):
            x = getattr(self, f"Bottleneck_{i}")(x)
        return x


class FPNNeck(nn.Module):
    """Lateral + top-down + smooth + the extra stride-64 level.
    forward({2, 3, 4, 5}: NCHW feats) -> {stride: NCHW} for strides 64, 32,
    16, 8, 4. ``cins`` are the channel counts of stages 2..5."""

    def __init__(self, cins=(256, 512, 1024, 2048), width: int = 256):
        super().__init__()
        for s, cin in zip((4, 8, 16, 32), cins):
            setattr(self, f"fpn_ft{s}_1x1", Conv2d(cin, width, 1, bias=True))
        for s in (32, 16, 8, 4):
            setattr(self, f"fpn_ft{s}_3x3", Conv2d(width, width, 3, padding=1,
                                                   bias=True))
        self.fpn_ft64_3x3 = Conv2d(width, width, 3, stride=2, padding=1, bias=True)

    def forward(self, feats):
        ft32 = self.fpn_ft32_1x1(feats[5])
        ft16 = self.fpn_ft16_1x1(feats[4])
        ft8 = self.fpn_ft8_1x1(feats[3])
        ft4 = self.fpn_ft4_1x1(feats[2])

        def up2(x):
            # nearest x2 (mx.symbol.UpSampling sample_type='nearest')
            return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)

        ft16p = up2(ft32) + ft16
        ft8p = up2(ft16p) + ft8
        ft4p = up2(ft8p) + ft4
        return {64: self.fpn_ft64_3x3(ft32), 32: self.fpn_ft32_3x3(ft32),
                16: self.fpn_ft16_3x3(ft16p), 8: self.fpn_ft8_3x3(ft8p),
                4: self.fpn_ft4_3x3(ft4p)}


def roi_level_dispatch(rois: torch.Tensor) -> torch.Tensor:
    """feat_id in {0, 1, 2, 3} -> strides (4, 8, 16, 32) (reference
    core/rcnn.py:55): clip(floor(2 + log2(sqrt(w*h)/224)), 0, 3)."""
    return roi_levels(rois, len(DISPATCH_STRIDES))


def pool_pyramid(pyramid, rois: torch.Tensor, pooled_size: int = 7,
                 roi_method: str = "align"):
    """7x7 ROIAlign (``roi_method='align'``) or exact ROIPooling ('pool')
    of every ROI at its dispatch level: pyramid {stride: [h, w, C]}, rois
    [R, 4] -> [R, P, P, C]. ROIAlign is one call over the four levels that
    reads nothing back to the host (on the card one kernel launch picks each
    ROI's level; ops/kernels/roi_align.py). ROIPooling groups the ROIs by
    level (one host read of the four counts), pools level by level and puts
    them back in their order."""
    if roi_method != "pool":
        return roi_align_levels([pyramid[s] for s in DISPATCH_STRIDES],
                                [1.0 / s for s in DISPATCH_STRIDES], rois,
                                pooled_size)
    fid = roi_level_dispatch(rois)
    order = torch.argsort(fid, stable=True)
    trace.count("host_read.fpn_level_counts")
    counts = torch.bincount(fid, minlength=len(DISPATCH_STRIDES)).tolist()
    parts, lo = [], 0
    for s, n in zip(DISPATCH_STRIDES, counts):
        if n:
            parts.append(roi_pool(pyramid[s], rois[order[lo:lo + n]], 1.0 / s,
                                  pooled_size))
        lo += n
    pooled = torch.cat(parts)
    out = torch.empty_like(pooled)
    out[order] = pooled
    return out


class _TinyPyramid(nn.Module):
    """Toy multi-stage trunk of the tests: stages 2/3/4 at strides 4/8/16,
    3x3/2 convs with flax 'SAME' padding and 16 channels. Accepts NHWC or
    s2d planar input (undone, as the JAX package does)."""

    def __init__(self, width: int = 16):
        super().__init__()
        self.plan = ((2, 2), (3, 1), (4, 1))
        cin = 3
        for stage, reps in self.plan:
            for r in range(reps):
                setattr(self, f"t{stage}_{r}", Conv2d(cin, width, 3, stride=2,
                                                      bias=True))
                cin = width

    def forward(self, x):
        if x.dim() == 4 and x.shape[1] == 12:
            B, K, Ho, Wo = x.shape
            x = (x.reshape(B, 2, 2, 3, Ho, Wo).permute(0, 4, 1, 5, 2, 3)
                 .reshape(B, 2 * Ho, 2 * Wo, 3))
        x = x.permute(0, 3, 1, 2)
        outs = {}
        for stage, reps in self.plan:
            for r in range(reps):
                h, w = x.shape[-2:]
                ph = max((-(-h // 2) - 1) * 2 + 3 - h, 0)
                pw = max((-(-w // 2) - 1) * 2 + 3 - w, 0)
                x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
                x = F.relu(getattr(self, f"t{stage}_{r}")(x))
            outs[stage] = x
        return outs


class RelationRCNNFPN(nn.Module):
    """The FPN detector; the arguments mirror the flax module's fields.
    ``lnms_allow_pallas`` and ``compact_classes`` pick the learned-NMS
    attention's branch (models/relation.py::NMSRelationModule): False (the
    default, TPU.FPN_ALLOW_PALLAS) is the JAX package's XLA branch, which the
    port runs as two kernels, geometric bias then attention, over the active
    classes when at most ``compact_classes`` are active. The head's relation
    modules always run the geometric-bias kernel. ``roi_method`` as in
    ``pool_pyramid``."""

    def __init__(self, num_classes: int = 81, num_anchors: int = 3,
                 class_agnostic: bool = True, use_relation: bool = True,
                 use_learn_nms: bool = True, first_n: int = 100,
                 num_thresh: int = 5, bbox_means=None, bbox_stds=None,
                 backbone: str = "resnet101", head_dim: int = 1024,
                 conv_dtype: torch.dtype = torch.bfloat16,
                 head_dtype: torch.dtype = torch.float32,
                 freeze_through: int = 0, lnms_allow_pallas: bool = False,
                 compact_classes: int = 32, roi_method: str = "align"):
        super().__init__()
        if roi_method not in ("align", "pool"):
            raise ValueError(f"roi_method {roi_method!r}: 'align' or 'pool'")
        self.backbone = backbone
        self.roi_method = roi_method
        self.conv_dtype = conv_dtype
        self.use_relation, self.use_learn_nms = use_relation, use_learn_nms
        if backbone == "resnet101":
            self.c4 = ResNet101C4(dtype=conv_dtype, freeze_through=freeze_through,
                                  out_stages=(2, 3, 4))
            self.c5 = ResNet101C5Standard()
            cins = (256, 512, 1024, 2048)
        else:
            self.c4 = _TinyPyramid()
            self.c5 = None                   # a 2x2 max pool
            cins = (16, 16, 16, 16)
        self.neck = FPNNeck(cins)
        self.rpn = RPNHead(256, num_anchors)
        self.roi_pool_fc1 = Dense(7 * 7 * 256, head_dim, head_dtype)
        self.roi_pool_fc2 = Dense(head_dim, head_dim, head_dtype)
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

    def features_and_rpn(self, image: torch.Tensor):
        """image [H, W, 3] or s2d [12, H/2, W/2] (mean-subtracted BGR); a 4D
        input is an explicit batch. -> ({stride: [(B,) h, w, 256]},
        {stride: (rpn_cls [(B,) h, w, 2A], rpn_bbox [(B,) h, w, 4A])}), the
        RPN outputs in f32. The FPN trunk has no fused path (no
        ``res4_folded``)."""
        batched = image.dim() == 4
        x = image if batched else image[None]
        feats = self.c4(x)                                     # {2, 3, 4} NCHW
        feats[5] = (F.max_pool2d(feats[4], 2, 2) if self.c5 is None
                    else self.c5(feats[4]))
        levels = self.neck(feats)
        rpn_out = {s: self.rpn(levels[s], raw=True) for s in FPN_STRIDES}
        pyramid = {s: f.permute(0, 2, 3, 1) for s, f in levels.items()}
        if batched:
            return pyramid, rpn_out
        return ({s: f[0] for s, f in pyramid.items()},
                {s: (c[0], b[0]) for s, (c, b) in rpn_out.items()})

    def head(self, pyramid, rois, nongt_dim: int, pool_only: bool = False):
        """4-level pooled head: pyramid {stride: [h, w, 256]}, rois [N, 4] ->
        (cls_score [N, K], bbox_pred [N, 4*num_reg], fc2 [N, D]).
        ``pool_only`` returns the flattened pooled features (the train
        step's stop_after='pool' cut)."""
        pooled = pool_pyramid(pyramid, rois, roi_method=self.roi_method)
        flat = pooled.reshape(pooled.shape[0], -1).float()
        if pool_only:
            return flat
        if self.use_relation:
            pos_t = extract_position_matrix_t(rois, nongt_dim)
        x = self.roi_pool_fc1(flat)
        if self.use_relation:
            x = x + self.relation_1(x, pos_t)
        x = self.roi_pool_fc2(F.relu(x))
        if self.use_relation:
            x = x + self.relation_2(x, pos_t)
        fc2 = F.relu(x)
        return self.cls_score(fc2), self.bbox_pred(fc2), fc2

    def learn_nms(self, cls_score, bbox_pred, rois, roi_feat, im_info,
                  class_thresh: float = 0.0, allow_pallas: bool | None = None,
                  probe: str = ""):
        """The learned-NMS head; ``allow_pallas`` overrides the attention
        branch of this call (the split predict functions' tail), ``probe``
        cuts it (LearnNMSHead.forward)."""
        return self.learn_nms_head(cls_score, bbox_pred, rois, roi_feat,
                                   im_info, class_thresh, allow_pallas, probe)


def fpn_anchors(feat_shapes: dict, scales, ratios, device=None):
    """Per-level anchor grids {stride: [h*w*A, 4]} in (h, w, a) order
    (assign_pyramid_anchor, lib/rpn/rpn.py:246-300: base size = stride)."""
    return {stride: shift_anchors(generate_anchors(stride, ratios, scales),
                                  fh, fw, stride, device=device)
            for stride, (fh, fw) in feat_shapes.items()}


def generate_proposals_fpn(rpn_out: dict, base_anchors: dict, im_info,
                           pre_nms_top_n: int, post_nms_top_n: int,
                           nms_thresh: float, min_size: float):
    """Joint proposal generation over the pyramid: decode every level,
    merge, one exact top-k (descending, lower index first among ties, as
    lax.top_k) and one NMS (the NMS kernel on the card).

    rpn_out: {stride: (rpn_cls [h, w, 2A] raw conv layout, rpn_bbox
    [h, w, 4A])}; base_anchors: {stride: [A, 4]} (generate_anchors(stride,
    ratios, scales)). Returns (rois [post_N, 4], scores [post_N], real
    [post_N] bool)."""
    scores, coords = [], []
    for stride, (cls, bbox) in rpn_out.items():
        tc = cls.permute(2, 0, 1).float()                        # [2A, H, W]
        # 2-class softmax fg prob == sigmoid(fg_logit - bg_logit)
        fg = torch.sigmoid(tc[1::2] - tc[0::2]).reshape(-1)      # (a, h, w)
        td = bbox.permute(2, 0, 1).float()                       # [4A, H, W]
        deltas = [td[i::4].reshape(-1) for i in range(4)]
        box, ok = decode_level(deltas, base_anchors[stride], tc.shape[1],
                               tc.shape[2], stride, im_info, min_size)
        scores.append(torch.where(ok, fg, torch.full_like(fg, _NEG_INF)))
        coords.append(box)
    scores = torch.cat(scores)
    box = torch.cat(coords, dim=1)                               # [4, K]
    k = min(pre_nms_top_n, scores.shape[0])
    top_scores, top_idx = torch.sort(scores, descending=True, stable=True)
    top_scores, top_idx = top_scores[:k], top_idx[:k]
    top_bT = box[:, top_idx]
    keep_idx, real = nms_topk_presorted(top_bT, top_scores,
                                        top_scores > _NEG_INF / 2, nms_thresh,
                                        post_nms_top_n)
    return top_bT[:, keep_idx].T, top_scores[keep_idx], real
