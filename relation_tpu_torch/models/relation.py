"""Object relation modules: multi-head attention between ROI features with
a log-clamped geometric bias (port of relation_tpu/models/relation.py;
reference attention_module_multi_head / attention_module_nms_multi_head).

The geometric bias runs through ops/kernels/geom_bias.py (forward and
backward). The learned-NMS attention over every class runs in two stages:
the geometric-bias kernel, then the bias-attention kernel of
ops/kernels/bias_attention.py. A request with at most C/2 active classes
takes the fused skip kernel of ops/kernels/nms_attention.py, and with
``fully_fused`` the unfiltered (training) call takes its differentiable form
over every class. With ``allow_pallas=False`` (the JAX package's XLA branch,
the FPN default) a request with few active classes runs the two stages over
the active classes only.
Parameter names and layouts follow the flax tree: pair_pos_fc1 and the
query/key denses are ``nn.Linear``s ([out, in]), linear_out is a raw
[groups, feat, out/groups] weight.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from relation_tpu_torch.ops.kernels.bias_attention import (
    fused_bias_attention, fused_bias_attention_skip)
from relation_tpu_torch.ops.kernels.geom_bias import (fused_geometric_bias,
                                                      fused_geometric_bias_skip)
from relation_tpu_torch.ops.kernels.nms_attention import (
    fused_nms_relation_attention, fused_nms_relation_attention_skip)


class Dense(nn.Linear):
    """flax nn.Dense with ``dtype=``: input and params cast to ``dtype``."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class GeomBiasDense(nn.Linear):
    """pair_pos_fc1 as the fused geometric bias: weight [G, 64], bias [G];
    forward pos [C, 4, N, M] -> log(max(emb @ W^T + b, 1e-6)) [C, G, N, M]."""

    def __init__(self, groups: int):
        super().__init__(64, groups)

    def forward(self, pos_t):
        return fused_geometric_bias(pos_t, self.weight.t(), self.bias)


class RelationModule(nn.Module):
    """One relation block of the detection head:
    (roi_feat [N, F], position_mat_t [4, N, K]) -> [N, dim_out], keys and
    values the first K (= nongt_dim) rows of roi_feat."""

    def __init__(self, index: int, feat_dim: int, dim_qk: int, dim_out: int,
                 groups: int = 16, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.index, self.groups = index, groups
        self.dim_qk, self.dim_out = dim_qk, dim_out
        setattr(self, f"pair_pos_fc1_{index}", GeomBiasDense(groups))
        setattr(self, f"query_{index}", Dense(feat_dim, dim_qk, dtype))
        setattr(self, f"key_{index}", Dense(feat_dim, dim_qk, dtype))
        setattr(self, f"linear_out_{index}_weight", nn.Parameter(
            torch.empty(groups, feat_dim, dim_out // groups)))
        setattr(self, f"linear_out_{index}_bias", nn.Parameter(
            torch.zeros(dim_out)))

    def forward(self, roi_feat, position_mat_t):
        i = self.index
        n = roi_feat.shape[0]
        k = position_mat_t.shape[2]
        g = self.groups
        d = self.dim_qk // g
        nongt = roi_feat[:k]
        bias = getattr(self, f"pair_pos_fc1_{i}")(position_mat_t[None])[0]
        bias = bias.permute(1, 0, 2)                            # [N, g, K]
        q = getattr(self, f"query_{i}")(roi_feat).reshape(n, g, d)
        kk = getattr(self, f"key_{i}")(nongt).reshape(k, g, d)
        aff = torch.einsum("ngd,kgd->ngk", q, kk) / (float(d) ** 0.5)
        attn = torch.softmax(aff.float() + bias, dim=-1)
        out = torch.einsum("ngk,kf->ngf", attn.to(nongt.dtype), nongt)
        w = getattr(self, f"linear_out_{i}_weight")
        y = torch.einsum("ngf,gfe->nge", out, w.to(out.dtype))
        return y.reshape(n, self.dim_out).float() + getattr(
            self, f"linear_out_{i}_bias")


class NMSRelationModule(nn.Module):
    """Per-class relation attention of the learned-NMS head:
    roi_feat [N, C, F], position_mat_t [C, 4, N, N], optional active [C]
    -> [N, C, dim_out].

    The query and key denses compute in ``dtype``. The dense path over
    every class is two kernels: the geometric bias, then the bias attention;
    both carry gradients. Where the JAX package runs that path's einsums in
    ``dtype`` (``_dense_attention_impl``: the Pallas dense route and both
    XLA routes), the port rounds their operands to ``dtype`` as JAX casts
    them (q and k, the values, linear_out), runs the f32 kernels on the
    rounded values and rounds the output to ``dtype``, as JAX's last einsum
    returns it; the geometric bias and the softmax stay f32, as in JAX. JAX
    also rounds the scores, the attention and attn @ v to ``dtype`` inside
    the path; the kernels keep those in f32. The skip and fully fused
    kernels take f32 operands, as JAX's do.

    ``allow_pallas`` (True, the C4 default) picks the JAX package's Pallas
    branch. With ``active`` (inference) and at most C/2 active classes (a
    host-side decision on one scalar) the fused skip kernel runs and leaves
    inactive classes unwritten; otherwise the dense path runs. Without
    ``active`` (training computes every class) ``fully_fused`` (a field, off
    by default as in the JAX package; set it on the built module) picks the
    single fused kernel over all classes in place of the dense path; it also
    carries gradients.

    ``allow_pallas=False`` (the FPN default) is the JAX package's XLA branch
    (relation.py:171-201): the materialised [C, G, N, N] geometric bias, then
    the attention, which is the dense path. With ``active`` and at most
    ``compact_classes`` (< C) active classes, the skip forms of both kernels
    run over the active classes only (the JAX compact path gathers them into
    a batch of ``compact_classes``; the rows of active classes are the same,
    and the others are masked by the learned-NMS head's where())."""

    def __init__(self, index: int, feat_dim: int, dim_qk: int = 1024,
                 dim_out: int = 128, groups: int = 16,
                 dtype: torch.dtype = torch.float32,
                 fully_fused: bool = False, allow_pallas: bool = True,
                 compact_classes: int = 32):
        super().__init__()
        self.index, self.groups = index, groups
        self.fully_fused = fully_fused
        self.allow_pallas, self.compact_classes = allow_pallas, compact_classes
        self.dim_qk, self.dim_out = dim_qk, dim_out
        setattr(self, f"nms_query_{index}", Dense(feat_dim, dim_qk, dtype))
        setattr(self, f"nms_key_{index}", Dense(feat_dim, dim_qk, dtype))
        setattr(self, f"nms_pair_pos_fc1_{index}", nn.Linear(64, groups))
        setattr(self, f"nms_linear_out_{index}_weight", nn.Parameter(
            torch.empty(groups, feat_dim, dim_out // groups)))
        setattr(self, f"nms_linear_out_{index}_bias", nn.Parameter(
            torch.zeros(dim_out)))

    def forward(self, roi_feat, position_mat_t, active=None,
                allow_pallas: bool | None = None):
        """``allow_pallas`` overrides the field for this call."""
        i = self.index
        n, c, _ = roi_feat.shape
        g = self.groups
        feat = roi_feat.transpose(0, 1)                         # [C, N, F]
        q = getattr(self, f"nms_query_{i}")(feat)
        k = getattr(self, f"nms_key_{i}")(feat)
        pp = getattr(self, f"nms_pair_pos_fc1_{i}")
        wg, bg = pp.weight.t(), pp.bias
        wl = getattr(self, f"nms_linear_out_{i}_weight")
        if not (self.allow_pallas if allow_pallas is None else allow_pallas):
            m = self.compact_classes
            if active is not None and 0 < m < c and int(active.sum()) <= m:
                dt = q.dtype
                bias = fused_geometric_bias_skip(position_mat_t, wg, bg, active)
                y = fused_bias_attention_skip(
                    bias, q.float(), k.float(), feat.to(dt).float(),
                    wl.to(dt).float(), active).to(dt).float()
            else:
                y = _dense_attention(position_mat_t, q, k, feat, wg, bg, wl)
        elif active is not None and int(active.sum()) <= c // 2:
            y = fused_nms_relation_attention_skip(
                position_mat_t, q.float(), k.float(), feat.float(), wg, bg,
                wl, active)
        elif active is None and self.fully_fused:
            y = fused_nms_relation_attention(
                position_mat_t, q.float(), k.float(), feat.float(), wg, bg, wl)
        else:
            y = _dense_attention(position_mat_t, q, k, feat, wg, bg, wl)
        y = y + getattr(self, f"nms_linear_out_{i}_bias")
        return y.transpose(0, 1)                                # [N, C, out]


def _dense_attention(position_mat_t, q, k, feat, wg, bg, wl):
    """Every class in two stages: the geometric-bias kernel, then the
    bias-attention kernel, both f32 and both carrying gradients; the values
    and linear_out rounded to q's dtype first and the output after, as JAX
    casts them."""
    dt = q.dtype
    bias = fused_geometric_bias(position_mat_t, wg, bg)        # [C, g, N, N]
    return fused_bias_attention(bias, q.float(), k.float(), feat.to(dt).float(),
                                wl.to(dt).float()).to(dt).float()
