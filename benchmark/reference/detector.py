"""Plain PyTorch reference of the two detectors the benchmark runs.

Relation Networks for Object Detection (Hu et al., CVPR 2018) on Faster
R-CNN: a ResNet-101 trunk (C4 with a dilated res5, or the FPN pyramid P2..P6
of Lin et al. 2017), an RPN, two relation modules in the 2FC head, and the
learned-NMS ("duplicate removal") head, with the layer layouts, constants
and loss scalings of the authors' MXNet symbols. Written from those
definitions with plain tensor operations in float32: no kernel, no cache,
no batching across images. It imports nothing of the program under test
and takes from it nothing but the outputs it judges.

Parameters are one flat dict {name: tensor}; ``param_specs`` lists the
names and shapes. The harness makes the weights from the seed by that list
and hands the same tensors to both sides.

The reference of every configuration that names none (its interface:
benchmark/reference/__init__.py); a reference of another detector can
import its trunk, relation and learned-NMS functions from here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.harness.flops import count_flops, meta_params

NEG_INF = -1e10
FPN_STRIDES = (64, 32, 16, 8, 4)        # P6..P2: the order levels are merged
DISPATCH_STRIDES = (4, 8, 16, 32)
# stage: (units, mid, out, stride of the first unit)
_STAGES = {2: (3, 64, 256, 1), 3: (4, 128, 512, 2), 4: (23, 256, 1024, 2)}


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

def _unit_names(stage: int, n: int):
    if stage in (2, 5):
        return [f"{stage}{s}" for s in "abc"[:n]]
    return [f"{stage}a"] + [f"{stage}b{i}" for i in range(1, n)]


def _bottleneck_specs(pre, p, cin, mid, out, proj):
    s = []
    if proj:
        s.append((f"{pre}.res{p}_branch1.weight", (out, cin, 1, 1)))
    s.append((f"{pre}.res{p}_branch2a.weight", (mid, cin, 1, 1)))
    s.append((f"{pre}.res{p}_branch2b.weight", (mid, mid, 3, 3)))
    s.append((f"{pre}.res{p}_branch2c.weight", (out, mid, 1, 1)))
    for br, ch in (("branch1", out), ("branch2a", mid), ("branch2b", mid),
                   ("branch2c", out)):
        if br == "branch1" and not proj:
            continue
        for leaf in ("gamma", "beta", "moving_mean", "moving_var"):
            s.append((f"{pre}.bn{p}_{br}.{leaf}", (ch,)))
    return s


def _trunk_specs(c5_prefix="c5"):
    s = [("c4.conv1.weight", (64, 3, 7, 7))]
    s += [(f"c4.bn_conv1.{leaf}", (64,))
          for leaf in ("gamma", "beta", "moving_mean", "moving_var")]
    i, cin = 0, 64
    for stage, (n, mid, out, _) in _STAGES.items():
        for u, name in enumerate(_unit_names(stage, n)):
            s += _bottleneck_specs(f"c4.Bottleneck_{i}", name, cin, mid, out,
                                   u == 0)
            i, cin = i + 1, out
    for i, name in enumerate(_unit_names(5, 3)):
        s += _bottleneck_specs(f"{c5_prefix}.Bottleneck_{i}", name,
                               1024 if i == 0 else 2048, 512, 2048, i == 0)
    return s


def _dense(name, cin, cout):
    return [(f"{name}.weight", (cout, cin)), (f"{name}.bias", (cout,))]


def _relation_specs(i):
    p = f"relation_{i}"
    return ([(f"{p}.linear_out_{i}_weight", (16, 1024, 64)),
             (f"{p}.linear_out_{i}_bias", (1024,))]
            + _dense(f"{p}.pair_pos_fc1_{i}", 64, 16)
            + _dense(f"{p}.query_{i}", 1024, 1024)
            + _dense(f"{p}.key_{i}", 1024, 1024))


def param_specs(arch: dict):
    """[(name, shape)] of every leaf of the detector ``arch`` describes
    (a configuration's "arch": "c4" or "fpn", num_classes, num_anchors)."""
    a = int(arch["num_anchors"])
    K = int(arch["num_classes"])
    s = _trunk_specs()
    rpn_cin = 1024 if arch["trunk"] == "c4" else 256
    s += [("rpn.rpn_conv_3x3.weight", (512, rpn_cin, 3, 3)),
          ("rpn.rpn_conv_3x3.bias", (512,)),
          ("rpn.rpn_cls_score.weight", (2 * a, 512, 1, 1)),
          ("rpn.rpn_cls_score.bias", (2 * a,)),
          ("rpn.rpn_bbox_pred.weight", (4 * a, 512, 1, 1)),
          ("rpn.rpn_bbox_pred.bias", (4 * a,))]
    if arch["trunk"] == "c4":
        s += [("conv_new_1.weight", (256, 2048, 1, 1)), ("conv_new_1.bias", (256,))]
        fc1, fc2 = "fc_new_1", "fc_new_2"
    else:
        for st, cin in zip((4, 8, 16, 32), (256, 512, 1024, 2048)):
            s += [(f"neck.fpn_ft{st}_1x1.weight", (256, cin, 1, 1)),
                  (f"neck.fpn_ft{st}_1x1.bias", (256,))]
        for st in (32, 16, 8, 4, 64):
            s += [(f"neck.fpn_ft{st}_3x3.weight", (256, 256, 3, 3)),
                  (f"neck.fpn_ft{st}_3x3.bias", (256,))]
        fc1, fc2 = "roi_pool_fc1", "roi_pool_fc2"
    s += _dense(fc1, 7 * 7 * 256, 1024) + _dense(fc2, 1024, 1024)
    s += _relation_specs(1) + _relation_specs(2)
    s += _dense("cls_score", 1024, K) + _dense("bbox_pred", 1024, 8)
    ln = "learn_nms_head"
    m = f"{ln}.NMSRelationModule_0"
    s += (_dense(f"{ln}.nms_rank", 1024, 128)
          + _dense(f"{ln}.roi_feat_embedding", 1024, 128)
          + [(f"{m}.nms_linear_out_1_weight", (16, 128, 8)),
             (f"{m}.nms_linear_out_1_bias", (128,))]
          + _dense(f"{m}.nms_query_1", 128, 1024)
          + _dense(f"{m}.nms_key_1", 128, 1024)
          + _dense(f"{m}.nms_pair_pos_fc1_1", 64, 16)
          + _dense(f"{ln}.nms_logit", 128, int(arch["num_thresh"])))
    return s


def trainable(name: str, fixed_prefixes) -> bool:
    """A leaf trains unless a component of its name starts with one of the
    YAML's FIXED_PARAMS prefixes; BatchNorm's four vectors never train."""
    prefixes = tuple(fixed_prefixes) + ("gamma", "beta", "moving_mean",
                                        "moving_var")
    return not any(c.startswith(p) for c in name.split(".") for p in prefixes)


# --------------------------------------------------------------------------
# trunk
# --------------------------------------------------------------------------

def _bn(P, name, x):
    scale = P[f"{name}.gamma"] / torch.sqrt(P[f"{name}.moving_var"] + 1e-5)
    shift = P[f"{name}.beta"] - P[f"{name}.moving_mean"] * scale
    return x * scale[None, :, None, None] + shift[None, :, None, None]


def _conv(P, name, x, stride=1, pad=0, dil=1):
    return F.conv2d(x, P[f"{name}.weight"], P.get(f"{name}.bias"), stride,
                    pad, dil)


def _bottleneck(P, pre, p, x, stride, dil, proj):
    sc = (_bn(P, f"{pre}.bn{p}_branch1", _conv(P, f"{pre}.res{p}_branch1", x,
                                                stride)) if proj else x)
    y = F.relu(_bn(P, f"{pre}.bn{p}_branch2a",
                   _conv(P, f"{pre}.res{p}_branch2a", x, stride)))
    y = F.relu(_bn(P, f"{pre}.bn{p}_branch2b",
                   _conv(P, f"{pre}.res{p}_branch2b", y, 1, dil, dil)))
    y = _bn(P, f"{pre}.bn{p}_branch2c", _conv(P, f"{pre}.res{p}_branch2c", y))
    return F.relu(sc + y)


def image_from_u8(img, im_info, pixel_means):
    """uint8 space-to-depth planar [12, H/2, W/2] (channel (pi*2 + pj)*3 + c)
    -> mean-subtracted BGR [1, 3, H, W] f32, zero outside the image's
    im_info (h, w)."""
    _, ho, wo = img.shape
    x = img.float().reshape(2, 2, 3, ho, wo).permute(2, 3, 0, 4, 1)
    x = x.reshape(3, 2 * ho, 2 * wo)
    x = x - torch.as_tensor(pixel_means, dtype=torch.float32,
                            device=x.device)[:, None, None]
    rows = torch.arange(2 * ho, device=x.device)[:, None] < im_info[0]
    cols = torch.arange(2 * wo, device=x.device)[None, :] < im_info[1]
    return (x * (rows & cols))[None]


def trunk(P, x, fpn: bool, no_grad_through: int = 0):
    """conv1 .. res4b22 (and res5): the C4 feature [B, 1024, h, w] and
    res5 dilated at stride 16 for C4; {2, 3, 4, 5} stage maps for FPN.
    Stages up to ``no_grad_through`` run without gradient (they are
    frozen, so none is lost)."""
    grad = torch.is_grad_enabled()
    with torch.set_grad_enabled(grad and no_grad_through < 2):
        x = F.relu(_bn(P, "c4.bn_conv1", F.conv2d(x, P["c4.conv1.weight"],
                                                  None, 2, 3)))
        x = F.max_pool2d(x, 3, 2, 1)
    outs, i = {}, 0
    for stage, (n, _, _, stride) in _STAGES.items():
        with torch.set_grad_enabled(grad and stage > no_grad_through):
            for u, name in enumerate(_unit_names(stage, n)):
                x = _bottleneck(P, f"c4.Bottleneck_{i}", name, x,
                                stride if u == 0 else 1, 1, u == 0)
                i += 1
        outs[stage] = x
    y = x
    for u, name in enumerate(_unit_names(5, 3)):
        y = _bottleneck(P, f"c5.Bottleneck_{u}", name, y,
                        2 if (fpn and u == 0) else 1, 1 if fpn else 2, u == 0)
    outs[5] = y
    return outs


def fpn_neck(P, outs):
    """{stride: NCHW} for 64, 32, 16, 8, 4: laterals, nearest x2 top-down
    sums, 3x3 smoothing; P6 a stride-2 3x3 on the stride-32 lateral."""
    lat = {s: _conv(P, f"neck.fpn_ft{s}_1x1", outs[k])
           for s, k in ((32, 5), (16, 4), (8, 3), (4, 2))}

    def up2(t):
        return t.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    p16 = up2(lat[32]) + lat[16]
    p8 = up2(p16) + lat[8]
    p4 = up2(p8) + lat[4]
    return {64: _conv(P, "neck.fpn_ft64_3x3", lat[32], 2, 1),
            32: _conv(P, "neck.fpn_ft32_3x3", lat[32], 1, 1),
            16: _conv(P, "neck.fpn_ft16_3x3", p16, 1, 1),
            8: _conv(P, "neck.fpn_ft8_3x3", p8, 1, 1),
            4: _conv(P, "neck.fpn_ft4_3x3", p4, 1, 1)}


def rpn_head(P, feat):
    """NCHW -> (cls [B, h, w, 2A], bbox [B, h, w, 4A]); channel a*2 + j is
    (anchor a, background/foreground j), a*4 + j (anchor a, delta j)."""
    x = F.relu(_conv(P, "rpn.rpn_conv_3x3", feat, 1, 1))
    return (_conv(P, "rpn.rpn_cls_score", x).permute(0, 2, 3, 1),
            _conv(P, "rpn.rpn_bbox_pred", x).permute(0, 2, 3, 1))


# --------------------------------------------------------------------------
# anchors, proposals, NMS
# --------------------------------------------------------------------------

def base_anchors(base_size, ratios, scales):
    """[A, 4] (py-faster-rcnn generate_anchors): ratio-major, scale-minor."""
    ratios = np.asarray(ratios, np.float64)
    scales = np.asarray(scales, np.float64)
    w = h = float(base_size)
    cx = cy = 0.5 * (w - 1)
    ws = np.round(np.sqrt(w * h / ratios))
    hs = np.round(ws * ratios)
    out = []
    for wr, hr in zip(ws, hs):
        a, b = wr * scales, hr * scales
        out.append(np.stack([cx - 0.5 * (a - 1), cy - 0.5 * (b - 1),
                             cx + 0.5 * (a - 1), cy + 0.5 * (b - 1)], 1))
    return np.concatenate(out).astype(np.float32)


def decode_proposals(fg, deltas, anchors_a, H, W, stride, im_info):
    """One level: fg [A, H, W], deltas [A, 4, H, W], base anchors [A, 4]
    -> (boxes [A*H*W, 4] clipped, scores with cells outside the image at
    -inf), both flattened in (a, h, w) order."""
    dev = fg.device
    an = torch.as_tensor(anchors_a, device=dev)
    sx = torch.arange(W, device=dev, dtype=torch.float32) * stride
    sy = torch.arange(H, device=dev, dtype=torch.float32) * stride
    ax1 = an[:, 0, None, None] + sx[None, None, :] + 0 * sy[None, :, None]
    ay1 = an[:, 1, None, None] + sy[None, :, None] + 0 * sx[None, None, :]
    ax2 = an[:, 2, None, None] + sx[None, None, :] + 0 * sy[None, :, None]
    ay2 = an[:, 3, None, None] + sy[None, :, None] + 0 * sx[None, None, :]
    aw, ah = ax2 - ax1 + 1.0, ay2 - ay1 + 1.0
    acx, acy = ax1 + 0.5 * (aw - 1.0), ay1 + 0.5 * (ah - 1.0)
    dx, dy, dw, dh = deltas.unbind(1)
    cx, cy = dx * aw + acx, dy * ah + acy
    pw, ph = torch.exp(dw) * aw, torch.exp(dh) * ah
    hmax, wmax = im_info[0] - 1, im_info[1] - 1
    x1 = (cx - 0.5 * (pw - 1)).clamp(min=0).minimum(wmax)
    y1 = (cy - 0.5 * (ph - 1)).clamp(min=0).minimum(hmax)
    x2 = (cx + 0.5 * (pw - 1)).clamp(min=0).minimum(wmax)
    y2 = (cy + 0.5 * (ph - 1)).clamp(min=0).minimum(hmax)
    inside = ((torch.arange(H, device=dev)[:, None] < torch.floor(im_info[0] / stride))
              & (torch.arange(W, device=dev)[None, :] < torch.floor(im_info[1] / stride)))
    score = torch.where(inside[None].expand_as(fg), fg,
                        torch.full_like(fg, NEG_INF))
    boxes = torch.stack([x1, y1, x2, y2], -1).reshape(-1, 4)
    return boxes, score.reshape(-1)


def iou(a, b):
    """IoU matrix of [N, 4] and [M, 4] boxes, +1 widths."""
    ix1 = torch.maximum(a[:, None, 0], b[None, :, 0])
    iy1 = torch.maximum(a[:, None, 1], b[None, :, 1])
    ix2 = torch.minimum(a[:, None, 2], b[None, :, 2])
    iy2 = torch.minimum(a[:, None, 3], b[None, :, 3])
    inter = (ix2 - ix1 + 1).clamp(min=0) * (iy2 - iy1 + 1).clamp(min=0)
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    union = area_a[:, None] + area_b[None, :] - inter
    return torch.where(inter > 0, inter / union, torch.zeros_like(inter))


def greedy_nms(boxes, valid, thresh, max_keep):
    """Greedy NMS of boxes already in descending score order: a box is kept
    unless an earlier kept box overlaps it by IoU > thresh; stops after
    ``max_keep``. Returns the kept positions (host list)."""
    over = (iou(boxes, boxes) > thresh).cpu().numpy()
    ok = valid.cpu().numpy().copy()
    keep = []
    for i in range(len(ok)):
        if not ok[i]:
            continue
        keep.append(i)
        if len(keep) == max_keep:
            break
        ok &= ~over[i]
    return keep


def proposals(levels, im_info, top, anchor_cfg):
    """Every level decoded, merged in the order given, the ``pre`` highest
    scores (ties: lower index first), greedy NMS, the ``post`` best kept,
    padded by cycling through them. levels: [(fg [A, H, W], deltas
    [A, 4, H, W], stride)]. Returns rois [post, 4]."""
    pre, post, thresh = top
    boxes, scores = [], []
    for fg, d, stride in levels:
        A, H, W = fg.shape
        b, s = decode_proposals(fg, d, base_anchors(stride, *anchor_cfg), H, W,
                                stride, im_info)
        boxes.append(b)
        scores.append(s)
    boxes, scores = torch.cat(boxes), torch.cat(scores)
    order = torch.sort(scores, descending=True, stable=True).indices[:pre]
    sb, ss = boxes[order], scores[order]
    keep = greedy_nms(sb, ss > NEG_INF / 2, thresh, post)
    idx = [keep[i % len(keep)] for i in range(post)]
    return sb[idx]


# --------------------------------------------------------------------------
# ROI head
# --------------------------------------------------------------------------

def roi_align(feat, rois, scale, P=7, S=2):
    """feat [H, W, C]; rois [R, 4] -> [R, P, P, C]: each bin the mean of
    S x S bilinear samples (coordinates clamped into the map)."""
    H, W, C = feat.shape
    R = rois.shape[0]
    r = rois.detach() * scale
    rw = (r[:, 2] - r[:, 0]).clamp(min=1.0)
    rh = (r[:, 3] - r[:, 1]).clamp(min=1.0)
    g = (torch.arange(P * S, device=feat.device, dtype=torch.float32) + 0.5) / S
    ys = (r[:, 1, None] + (rh / P)[:, None] * g).clamp(0, H - 1)
    xs = (r[:, 0, None] + (rw / P)[:, None] * g).clamp(0, W - 1)
    y, x = ys[:, :, None].expand(R, P * S, P * S), xs[:, None, :].expand(R, P * S, P * S)
    y0, x0 = torch.floor(y), torch.floor(x)
    y1, x1 = (y0 + 1).clamp(max=H - 1), (x0 + 1).clamp(max=W - 1)
    ly, lx = (y - y0)[..., None], (x - x0)[..., None]
    flat = feat.reshape(H * W, C)

    def take(yy, xx):
        return flat[(yy.long() * W + xx.long()).reshape(-1)].reshape(R, P * S, P * S, C)
    v = (take(y0, x0) * ((1 - ly) * (1 - lx)) + take(y0, x1) * ((1 - ly) * lx)
         + take(y1, x0) * (ly * (1 - lx)) + take(y1, x1) * (ly * lx))
    return v.reshape(R, P, S, P, S, C).mean(dim=(2, 4))


def pool_levels(pyramid, rois):
    """Each ROI pooled at its level: stride 4 * 2**clip(floor(2 +
    log2(sqrt(w*h)/224)), 0, 3)."""
    w = rois[:, 2] - rois[:, 0] + 1
    h = rois[:, 3] - rois[:, 1] + 1
    lvl = torch.floor(2 + torch.log2(torch.sqrt((w * h).clamp(min=1e-6)) / 224))
    lvl = lvl.clamp(0, 3).long()
    out = None
    for i, s in enumerate(DISPATCH_STRIDES):
        sel = torch.nonzero(lvl == i).flatten()
        if sel.numel() == 0:
            continue
        part = roi_align(pyramid[s], rois[sel], 1.0 / s)
        if out is None:
            out = part.new_zeros((rois.shape[0],) + part.shape[1:])
        out = out.index_copy(0, sel, part)
    return out


def _linear(P, name, x):
    return F.linear(x, P[f"{name}.weight"], P[f"{name}.bias"])


def pair_geometry(b):
    """[..., N, 4] -> [..., 4, N, N]: log|dx|/w, log|dy|/h (clamped at
    1e-3), log w ratio, log h ratio (centres at (x1 + x2) / 2)."""
    x1, y1, x2, y2 = b.unbind(-1)
    w = (x2 - x1 + 1).clamp(min=1e-3)
    h = (y2 - y1 + 1).clamp(min=1e-3)
    cx, cy = 0.5 * (x1 + x2), 0.5 * (y1 + y2)
    dx = torch.log(((cx[..., :, None] - cx[..., None, :]) / w[..., :, None]).abs().clamp(min=1e-3))
    dy = torch.log(((cy[..., :, None] - cy[..., None, :]) / h[..., :, None]).abs().clamp(min=1e-3))
    dw = torch.log(w[..., :, None] / w[..., None, :])
    dh = torch.log(h[..., :, None] / h[..., None, :])
    return torch.stack([dx, dy, dw, dh], dim=-3)


def geometric_bias(P, name, pos):
    """pos [..., 4, N, M] -> log(max(W emb(100 pos) + b, 1e-6)) [..., G, N, M];
    emb: per field 8 sines then 8 cosines at wave lengths 1000**(k/8)."""
    k = torch.arange(8, device=pos.device, dtype=torch.float32)
    freq = 1.0 / torch.pow(torch.tensor(1000.0, device=pos.device), k / 8)
    div = (100.0 * pos)[..., :, None, :, :] * freq[:, None, None]   # [..4,8,N,M]
    emb = torch.cat([torch.sin(div), torch.cos(div)], dim=-3)       # [..4,16,N,M]
    emb = emb.flatten(-4, -3)                                       # [..64,N,M]
    acc = torch.einsum("...fnm,gf->...gnm", emb, P[f"{name}.weight"])
    acc = acc + P[f"{name}.bias"][:, None, None]
    return torch.log(acc.clamp(min=1e-6))


def relation(P, i, x, pos):
    """Relation module i: x [N, 1024], pos [4, N, K]; the first K rows are
    the keys and values. 16 heads; per head the values are the whole
    feature, projected by the head's slice of linear_out."""
    p = f"relation_{i}"
    N, K = x.shape[0], pos.shape[2]
    bias = geometric_bias(P, f"{p}.pair_pos_fc1_{i}", pos).permute(1, 0, 2)
    q = _linear(P, f"{p}.query_{i}", x).reshape(N, 16, 64)
    k = _linear(P, f"{p}.key_{i}", x[:K]).reshape(K, 16, 64)
    attn = torch.softmax(torch.einsum("ngd,kgd->ngk", q, k) / 8.0 + bias, dim=-1)
    out = torch.einsum("ngk,kf->ngf", attn, x[:K])
    y = torch.einsum("ngf,gfe->nge", out, P[f"{p}.linear_out_{i}_weight"])
    return y.reshape(N, 1024) + P[f"{p}.linear_out_{i}_bias"]


def head(P, fc_names, pooled, rois, nongt):
    """pooled [R, 7, 7, 256] -> (cls_score [R, K], bbox_pred [R, 8], fc2)."""
    pos = pair_geometry(rois)[:, :, :nongt]
    x = _linear(P, fc_names[0], pooled.reshape(pooled.shape[0], -1))
    x = x + relation(P, 1, x, pos)
    x = _linear(P, fc_names[1], F.relu(x))
    x = x + relation(P, 2, x, pos)
    fc2 = F.relu(x)
    return _linear(P, "cls_score", fc2), _linear(P, "bbox_pred", fc2), fc2


def refine(rois, deltas, im_info, means, stds):
    """Class-agnostic deltas [N, 4] (de-normalised) on rois -> clipped
    boxes [N, 4]."""
    d = deltas * torch.as_tensor(stds, device=rois.device) + torch.as_tensor(
        means, device=rois.device)
    w, h = rois[:, 2] - rois[:, 0] + 1, rois[:, 3] - rois[:, 1] + 1
    cx, cy = rois[:, 0] + 0.5 * (w - 1), rois[:, 1] + 0.5 * (h - 1)
    ncx, ncy = cx + w * d[:, 0], cy + h * d[:, 1]
    nw, nh = w * torch.exp(d[:, 2]), h * torch.exp(d[:, 3])
    b = torch.stack([ncx - 0.5 * (nw - 1), ncy - 0.5 * (nh - 1),
                     ncx + 0.5 * (nw - 1), ncy + 0.5 * (nh - 1)], 1)
    lim = torch.stack([im_info[1] - 1, im_info[0] - 1, im_info[1] - 1,
                       im_info[0] - 1])
    return torch.minimum(b, lim).clamp(min=0)


def learn_nms(P, cls_score, bbox_pred, rois, fc2, im_info, first_n,
              means, stds, class_thresh=0.0):
    """The duplicate-removal head: per class the ``first_n`` highest
    scoring boxes, a rank embedding plus the ROI feature's embedding, one
    16-head relation module over each class's boxes (geometry of the
    refined boxes), and a sigmoid per IoU threshold times the score.
    class_thresh > 0 (inference) zeroes the classes whose best score is
    below min(class_thresh, the best of any class)."""
    ln = "learn_nms_head"
    m = f"{ln}.NMSRelationModule_0"
    boxes = refine(rois, bbox_pred.detach()[:, 4:8], im_info, means, stds)
    prob = torch.softmax(cls_score, dim=-1)[:, 1:]                   # [N, C]
    rank = torch.argsort(-prob, dim=0, stable=True)[:first_n]        # [F, C]
    score = torch.gather(prob, 0, rank)
    sbox = boxes[rank]                                               # [F, C, 4]
    r = torch.arange(first_n, device=prob.device, dtype=torch.float32)
    dim_mat = torch.pow(torch.tensor(1000.0, device=prob.device),
                        torch.arange(512, device=prob.device) * (2.0 / 1024))
    div = r[:, None] / dim_mat
    rank_emb = _linear(P, f"{ln}.nms_rank", torch.cat([torch.sin(div),
                                                      torch.cos(div)], -1))
    emb = _linear(P, f"{ln}.roi_feat_embedding", fc2)[rank] + rank_emb[:, None]
    feat = emb.transpose(0, 1)                                       # [C, F, 128]
    C, Fn = feat.shape[0], feat.shape[1]
    pos = pair_geometry(sbox.transpose(0, 1))                        # [C,4,F,F]
    bias = geometric_bias(P, f"{m}.nms_pair_pos_fc1_1", pos)         # [C,16,F,F]
    q = _linear(P, f"{m}.nms_query_1", feat).reshape(C, Fn, 16, 64)
    k = _linear(P, f"{m}.nms_key_1", feat).reshape(C, Fn, 16, 64)
    attn = torch.softmax(torch.einsum("cigd,cjgd->cgij", q, k) / 8.0 + bias, -1)
    av = torch.einsum("cgij,cjf->cgif", attn, feat)
    att = torch.einsum("cgif,gfe->cige", av, P[f"{m}.nms_linear_out_1_weight"])
    att = att.reshape(C, Fn, 128) + P[f"{m}.nms_linear_out_1_bias"]
    h = F.relu(emb + att.transpose(0, 1))
    cond = torch.sigmoid(_linear(P, f"{ln}.nms_logit", h))           # [F, C, T]
    if class_thresh > 0:
        best = score.max(dim=0).values
        active = best >= torch.clamp(best.max(), max=class_thresh)
        cond = torch.where(active[None, :, None], cond, torch.zeros_like(cond))
    return score[..., None] * cond, sbox, score


# --------------------------------------------------------------------------
# inference
# --------------------------------------------------------------------------

def predict(P, cfg, image_u8, im_info):
    """One request: uint8 s2d image, im_info (h, w, scale) -> detections
    [max_det, 6] (class, score, x1, y1, x2, y2 in original coordinates;
    class -1 pads)."""
    a = cfg["arch"]
    t = cfg["test"]
    anchor_cfg = (a["anchor_ratios"], a["anchor_scales"])
    x = image_from_u8(image_u8, im_info, a["pixel_means"])
    outs = trunk(P, x, a["trunk"] == "fpn")
    A = int(a["num_anchors"])
    top = (int(t["rpn_pre_nms_top_n"]), int(t["rpn_post_nms_top_n"]),
           float(t["rpn_nms_thresh"]))
    if a["trunk"] == "fpn":
        levels = fpn_neck(P, outs)
        raw = []
        for s in FPN_STRIDES:
            cls, bb = rpn_head(P, levels[s])
            c = cls[0].permute(2, 0, 1)
            fg = torch.sigmoid(c[1::2] - c[0::2])
            d = bb[0].permute(2, 0, 1).reshape(A, 4, *c.shape[1:])
            raw.append((fg, d, s))
        rois = proposals(raw, im_info, top, anchor_cfg)
        pyramid = {s: levels[s][0].permute(1, 2, 0) for s in DISPATCH_STRIDES}
        pooled = pool_levels(pyramid, rois)
        fc_names = ("roi_pool_fc1", "roi_pool_fc2")
    else:
        cls, bb = rpn_head(P, outs[4])
        h, w = cls.shape[1:3]
        fg = torch.softmax(cls[0].reshape(h, w, A, 2), -1)[..., 1].permute(2, 0, 1)
        d = bb[0].reshape(h, w, A, 4).permute(2, 3, 0, 1)
        rois = proposals([(fg, d, int(a["rpn_feat_stride"]))], im_info, top,
                         anchor_cfg)
        feat = F.relu(_conv(P, "conv_new_1", outs[5]))[0].permute(1, 2, 0)
        pooled = roi_align(feat, rois, 1.0 / 16)
        fc_names = ("fc_new_1", "fc_new_2")
    nongt = int(t["rpn_post_nms_top_n"])
    cls_score, bbox_pred, fc2 = head(P, fc_names, pooled, rois, nongt)
    multi, sbox, _ = learn_nms(P, cls_score, bbox_pred, rois, fc2, im_info,
                               int(t["first_n"]), a["bbox_means"],
                               a["bbox_stds"], float(t["class_score_thresh"]))
    final = multi.mean(dim=2)                                        # [F, C]
    Fn, C = final.shape
    flat = torch.where(final > float(t["score_thresh"]), final,
                       torch.full_like(final, NEG_INF)).reshape(-1)
    top_s, idx = torch.sort(flat, descending=True, stable=True)
    top_s, idx = top_s[:int(t["max_det"])], idx[:int(t["max_det"])]
    real = top_s > NEG_INF / 2
    cls_id = (idx % C + 1).float()
    boxes = (sbox / im_info[2]).reshape(-1, 4)[idx]
    dets = torch.cat([torch.where(real, cls_id, torch.full_like(cls_id, -1))[:, None],
                      torch.where(real, top_s, torch.zeros_like(top_s))[:, None],
                      boxes * real[:, None]], 1)
    return dets


# --------------------------------------------------------------------------
# training: the RCNN step on cached proposals
# --------------------------------------------------------------------------

def _smooth_l1(x, sigma):
    s2 = sigma * sigma
    return torch.where(x.abs() < 1 / s2, 0.5 * s2 * x * x, x.abs() - 0.5 / s2)


def _ce_valid(logits, labels):
    valid = labels >= 0
    nll = -torch.log_softmax(logits, -1).gather(
        1, labels.clamp(min=0)[:, None])[:, 0]
    return torch.where(valid, nll, torch.zeros_like(nll)).sum() / valid.sum().clamp(min=1)


def bbox_targets(ex, gt, means, stds):
    """Normalised regression targets (dx, dy, log dw, log dh), +1 widths."""
    ew, eh = ex[:, 2] - ex[:, 0] + 1, ex[:, 3] - ex[:, 1] + 1
    gw, gh = gt[:, 2] - gt[:, 0] + 1, gt[:, 3] - gt[:, 1] + 1
    ecx, ecy = ex[:, 0] + 0.5 * (ew - 1), ex[:, 1] + 0.5 * (eh - 1)
    gcx, gcy = gt[:, 0] + 0.5 * (gw - 1), gt[:, 1] + 0.5 * (gh - 1)
    t = torch.stack([(gcx - ecx) / (ew + 1e-14), (gcy - ecy) / (eh + 1e-14),
                     torch.log(gw / ew), torch.log(gh / eh)], 1)
    return (t - torch.as_tensor(means, device=ex.device)) / torch.as_tensor(
        stds, device=ex.device)


def nms_targets(sbox, score, gt, gt_valid, threshes):
    """The learned-NMS targets [F, C, T] (MXNet nms_multi_target): for each
    class, threshold and same-class ground truth, of the boxes that overlap
    it above the threshold and overlap no other same-class ground truth
    more, the highest-scoring one is marked 1 (the first box where no box
    qualifies); a mark stands only on a box that overlaps some same-class
    ground truth above the threshold."""
    Fn, C, _ = sbox.shape
    G = gt.shape[0]
    dev = sbox.device
    thr = torch.as_tensor(threshes, dtype=torch.float32, device=dev)
    valid_g = gt_valid[None, :] & (gt[:, 4].long()[None, :]
                                   == torch.arange(1, C + 1, device=dev)[:, None])
    ov = iou(sbox.reshape(Fn * C, 4), gt[:, :4]).reshape(Fn, C, G)
    ov = torch.where(valid_g[None], ov, torch.full((), -1.0, device=dev))
    best = F.one_hot(ov.argmax(dim=2), G).float()                   # [F, C, G]
    mask = ov[None] > thr[:, None, None, None]                      # [T, F, C, G]
    winner = (score[None, :, :, None] * mask * best[None]).argmax(dim=1)  # [T, C, G]
    marked = (F.one_hot(winner, Fn).bool() & valid_g[None, :, :, None]).any(dim=2)
    out = marked.permute(2, 1, 0) & mask.any(dim=3).permute(1, 2, 0)
    return (out & valid_g.any(dim=1)[None, :, None]).float()


def _keep_top(mask, priority, cap, k_max):
    """The ``cap`` highest priorities among ``mask`` (lower index first
    among ties), at most ``k_max``."""
    key = torch.where(mask, priority, torch.full_like(priority, -1e9))
    k_max = min(int(k_max), key.shape[0])
    idx = torch.sort(key, descending=True, stable=True).indices[:k_max]
    keep = torch.zeros_like(mask)
    keep[idx] = torch.arange(k_max, device=mask.device) < cap
    return keep & mask


def head_loss(P, cfg, pool, fc_names, rois, gt, gt_valid, im_info):
    """Everything after the proposals for one image: every ROI and ground
    truth box labelled (fg at IoU >= 0.5), the head, the BATCH_ROIS_OHEM
    hardest ROIs (cross-entropy + smooth L1) kept, the RCNN losses, and the
    learned-NMS loss over the first ``nongt`` ROIs. ``pool(all_rois)``
    gives the pooled features."""
    tr = cfg["train"]
    a = cfg["arch"]
    all_rois = torch.cat([rois, gt[:, :4]])
    valid = torch.cat([torch.ones(rois.shape[0], dtype=torch.bool,
                                  device=rois.device), gt_valid])
    ov = torch.where(gt_valid[None, :], iou(all_rois, gt[:, :4]),
                     torch.full((), -1.0, device=rois.device))
    max_ov, assign = ov.max(dim=1)
    max_ov = max_ov.clamp(min=0)
    fg = valid & (max_ov >= tr["fg_thresh"]) & (gt_valid.sum() > 0)
    bg = valid & (max_ov < tr["bg_thresh_hi"]) & (max_ov >= tr["bg_thresh_lo"])
    label = torch.where(fg, gt[assign, 4].long(),
                        torch.where(bg, torch.zeros_like(assign), torch.full_like(assign, -1)))
    tgt = bbox_targets(all_rois, gt[assign, :4], a["bbox_means"], a["bbox_stds"])
    tgt = torch.where(fg[:, None], tgt, torch.zeros_like(tgt))
    w = fg.float()[:, None].expand(-1, 4)
    btarget = torch.cat([torch.zeros_like(tgt), tgt], 1)             # agnostic
    bweight = torch.cat([torch.zeros_like(w), w], 1)

    nongt = min(int(tr["rpn_post_nms_top_n"]), rois.shape[0])
    cls_score, bbox_pred, fc2 = head(P, fc_names, pool(all_rois), all_rois, nongt)
    k = int(tr["batch_rois_ohem"])
    with torch.no_grad():
        per = (-torch.log_softmax(cls_score, -1).gather(1, label.clamp(min=0)[:, None])[:, 0]
               + (bweight * _smooth_l1(bbox_pred - btarget, 1.0)).sum(1))
        keep = _keep_top(label >= 0, per, k, k)
    olabel = torch.where(keep, label, torch.full_like(label, -1))
    oweight = bweight * keep[:, None]
    cls_loss = _ce_valid(cls_score, olabel)
    box_loss = (oweight * _smooth_l1(bbox_pred - btarget, 1.0)).sum() / k
    multi, sbox, score = learn_nms(P, cls_score[:nongt], bbox_pred[:nongt],
                                   all_rois[:nongt], fc2[:nongt], im_info,
                                   int(tr["first_n"]), a["bbox_means"],
                                   a["bbox_stds"])
    nt = nms_targets(sbox.detach(), score.detach(), gt, gt_valid,
                     tr["nms_target_thresh"])
    s = multi.clamp(0.0, 1.0 - 1e-7)
    norm = multi.shape[0] * multi.shape[2]
    pos = float(tr["nms_loss_scale"]) * (-nt * torch.log(s + 1e-8)).sum() / norm
    neg = float(tr["nms_loss_scale"]) * (-(1 - nt) * torch.log(1 - s + 1e-8)).sum() / norm
    nms_loss = float(tr["nms_pos_scale"]) * pos + neg
    return cls_loss + box_loss + nms_loss


def image_loss(P, cfg, b, i, no_grad_through):
    """One image's loss of the FPN RCNN step on the batch's cached ROIs."""
    a = cfg["arch"]
    gt, gv, info = b["gt_boxes"][i], b["gt_valid"][i], b["im_info"][i]
    x = image_from_u8(b["image"][i], info, a["pixel_means"])
    levels = fpn_neck(P, trunk(P, x, True, no_grad_through))
    pyramid = {s: levels[s][0].permute(1, 2, 0) for s in DISPATCH_STRIDES}
    return head_loss(P, cfg, lambda r: pool_levels(pyramid, r),
                     ("roi_pool_fc1", "roi_pool_fc2"), b["rois"][i], gt, gv,
                     info)


def train_steps(P0, cfg, batches, steps):
    """``steps`` SGD steps (momentum, weight decay added to the gradient of
    every trainable leaf) from the weights ``P0``, one batch a step, the
    loss the mean of its images'. Returns (losses [steps], first gradients
    {leaf: tensor}, final weights {leaf: tensor}) of the trainable leaves."""
    tr = cfg["train"]
    P = {k: v.detach().clone() for k, v in P0.items()}
    names = [k for k in P if trainable(k, tr["fixed_params"])]
    for k in names:
        P[k].requires_grad_(True)
    trace = {k: torch.zeros_like(P[k]) for k in names}
    losses, first = [], None
    no_grad_through = 2 if any(p.startswith("res2") for p in tr["fixed_params"]) else 0
    for step in range(steps):
        b = batches[step]
        total = 0.0
        B = b["image"].shape[0]
        for i in range(B):
            loss = image_loss(P, cfg, b, i, no_grad_through) / B
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        with torch.no_grad():
            for k in names:
                g = P[k].grad if P[k].grad is not None else torch.zeros_like(P[k])
                if step == 0:
                    first = first or {}
                    first[k] = g.clone()
                trace[k].mul_(tr["momentum"]).add_(g + tr["wd"] * P[k])
                P[k].sub_(tr["lr"] * trace[k])
                P[k].grad = None
    return losses, first, {k: P[k].detach() for k in names}


# --------------------------------------------------------------------------
# operation counts (benchmark/harness/flops.py: meta tensors, the counter)
# --------------------------------------------------------------------------

def _head_inputs(R):
    pooled = torch.empty((R, 7, 7, 256), device="meta")
    rois = torch.empty((R, 4), device="meta")
    return pooled, rois


def serve_flops(config) -> int:
    """Operations of one request: trunk, RPN, head over the proposals, the
    learned-NMS head over every class."""
    a, t = config["arch"], config["test"]
    H, W = config["images"]["bucket"]
    P = meta_params(param_specs(a))
    R, F_ = int(t["rpn_post_nms_top_n"]), int(t["first_n"])
    info = torch.tensor([H, W, 1.0], device="meta")
    fc = (("roi_pool_fc1", "roi_pool_fc2") if a["trunk"] == "fpn"
          else ("fc_new_1", "fc_new_2"))

    def run():
        x = torch.empty((1, 3, H, W), device="meta")
        outs = trunk(P, x, a["trunk"] == "fpn")
        if a["trunk"] == "fpn":
            for lvl in fpn_neck(P, outs).values():
                rpn_head(P, lvl)
        else:
            rpn_head(P, outs[4])
            _conv(P, "conv_new_1", outs[5])
        pooled, rois = _head_inputs(R)
        cls, box, fc2 = head(P, fc, pooled, rois, R)
        learn_nms(P, cls, box, rois, fc2, info, F_, a["bbox_means"],
                  a["bbox_stds"])
    with torch.no_grad():
        return count_flops(run)


def train_flops(config, rois_per_image: int, gt_per_image: int) -> int:
    """Operations of one image of the FPN RCNN step and the backward of
    every trainable leaf's path: trunk and neck (no RPN: the step has no
    RPN loss), the head over the ROIs and ground truth and the learned-NMS
    branch over the first ``nongt`` rows."""
    a, tr = config["arch"], config["train"]
    H, W = config["images"]["bucket"]
    P = meta_params(param_specs(a),
                    lambda name: trainable(name, tr["fixed_params"]))
    R = rois_per_image + gt_per_image
    nongt = min(int(tr["rpn_post_nms_top_n"]), rois_per_image)
    info = torch.tensor([H, W, 1.0], device="meta")

    def run():
        x = torch.empty((1, 3, H, W), device="meta")
        maps = list(fpn_neck(P, trunk(P, x, True, 2)).values())
        pooled, rois = _head_inputs(R)
        cls, box, fc2 = head(P, ("roi_pool_fc1", "roi_pool_fc2"), pooled,
                             rois, nongt)
        multi, _, _ = learn_nms(P, cls[:nongt], box[:nongt], rois[:nongt],
                                fc2[:nongt], info, int(tr["first_n"]),
                                a["bbox_means"], a["bbox_stds"])
        loss = cls.sum() + box.sum() + multi.sum() + sum(v.sum() for v in maps)
        loss.backward()
    return count_flops(run)


# --------------------------------------------------------------------------
# calibration (benchmark/tools/calibrate.py)
# --------------------------------------------------------------------------

def calibration_outputs(P, cfg, image_u8, im_info):
    """The four prediction layers' outputs over one request, bias removed,
    in the order a request runs them: yields (layer, output) for
    ``rpn.rpn_cls_score`` and ``rpn.rpn_bbox_pred`` (every level's every
    cell) and ``cls_score`` and ``bbox_pred`` (every proposal). Each output
    is computed when asked for, with the weights in ``P`` then: a caller
    that rescales a layer's weight before asking for the next has the
    later layers see it."""
    a = cfg["arch"]
    x = image_from_u8(image_u8, im_info, a["pixel_means"])
    outs = trunk(P, x, a["trunk"] == "fpn")
    feats = (list(fpn_neck(P, outs).values()) if a["trunk"] == "fpn"
             else [outs[4]])
    for layer in ("rpn.rpn_cls_score", "rpn.rpn_bbox_pred"):
        hid = [torch.relu(_conv(P, "rpn.rpn_conv_3x3", f, 1, 1)) for f in feats]
        yield layer, torch.cat([_conv(P, layer, h).flatten(1)
                                - P[f"{layer}.bias"][:, None] for h in hid], 1)
    # the head's input: the ROIs the RPN, as scaled now, proposes
    raw = []
    A = int(a["num_anchors"])
    t = cfg["test"]
    top = (int(t["rpn_pre_nms_top_n"]), int(t["rpn_post_nms_top_n"]),
           float(t["rpn_nms_thresh"]))
    if a["trunk"] == "fpn":
        levels = dict(zip(FPN_STRIDES, feats))
        for s in FPN_STRIDES:
            cls, bb = rpn_head(P, levels[s])
            cc = cls[0].permute(2, 0, 1)
            raw.append((torch.sigmoid(cc[1::2] - cc[0::2]),
                        bb[0].permute(2, 0, 1).reshape(A, 4, *cc.shape[1:]), s))
        rois = proposals(raw, im_info, top, (a["anchor_ratios"], a["anchor_scales"]))
        pooled = pool_levels({s: levels[s][0].permute(1, 2, 0)
                              for s in DISPATCH_STRIDES}, rois)
        fc = ("roi_pool_fc1", "roi_pool_fc2")
    else:
        cls, bb = rpn_head(P, feats[0])
        h, w = cls.shape[1:3]
        fg = torch.softmax(cls[0].reshape(h, w, A, 2), -1)[..., 1].permute(2, 0, 1)
        d = bb[0].reshape(h, w, A, 4).permute(2, 3, 0, 1)
        rois = proposals([(fg, d, 16)], im_info, top,
                         (a["anchor_ratios"], a["anchor_scales"]))
        feat = torch.relu(_conv(P, "conv_new_1", outs[5]))[0].permute(1, 2, 0)
        pooled = roi_align(feat, rois, 1.0 / 16)
        fc = ("fc_new_1", "fc_new_2")
    _, _, fc2 = head(P, fc, pooled, rois, rois.shape[0])
    for layer in ("cls_score", "bbox_pred"):
        yield layer, F.linear(fc2, P[f"{layer}.weight"])
