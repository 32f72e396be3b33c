"""Plain PyTorch reference of the deformable relation detector with learned
NMS: Deformable ConvNets v1 (Dai et al., ICCV 2017) on the ResNet-101 C4
Faster R-CNN of Relation Networks (Hu et al., CVPR 2018), the symbol
``resnet_v1_101_rcnn_dcn_attention_1024_pairwise_position_multi_head_16_
learn_nms``, trained END2END.

res2..res4, the RPN, the relation head and the learned-NMS head are
``benchmark/reference/detector.py``'s. What this file adds, written from
the published description in float32 (the caller turns TF32 off):

- res5: three bottlenecks whose 3x3 is a deformable convolution with 4
  deformable groups, stride 1, dilation 2, steered by a 3x3 offset conv of
  72 channels (dilation 2); offset channel ``g * 18 + 2 * tap + (0: dy,
  1: dx)``, taps row-major. Each tap of each output position samples the
  map bilinearly at its moved place, a sample counting where -1 < y < H
  and -1 < x < W and a corner outside the map adding 0; the samples are
  gathered one by one and multiplied by the weight, and autograd gives
  every gradient (no col2im, no hand-written backward).
- the head: a deformable PSROI pool (7x7 bins, part size 7, 4x4 samples a
  bin, group size 1, scale 1/16): ROI corners rounded, shifted by -0.5, a
  0.1 minimum size, each bin moved by ``trans * 0.1 * roi size``, a sample
  outside (-0.5, dim - 0.5) skipped, the rest clamped into the map and
  interpolated, each bin the mean of its samples inside (0 where none
  is). A pass without ``trans`` feeds the ``offset`` FC, whose output
  [R, 2, 7, 7] (x then y) moves the bins of the second pass. Samples are
  gathered per sample, in blocks of ROIs.
- training: anchor targets (MXNet's ``assign_anchor``), the RPN losses,
  the training proposals (6000 -> 300 at NMS 0.7, without gradient), then
  ``detector.head_loss`` (every proposal and ground-truth box labelled,
  OHEM 128, the learned-NMS targets at 0.5-0.9), SGD with momentum and
  weight decay, the ``offset`` FC at 0.01 of the rate.

Departures from the MXNet code, each shared with the program:

- the anchor sampler keeps the highest of uniform priorities handed in
  (``anchor_fg``, ``anchor_bg`` of a batch: [B, K] each) where MXNet draws
  ``npr.choice``: the same law, and both sides draw the same anchors;
- a ground-truth box that overlaps no anchor inside the image marks no
  anchor as its best (MXNet would mark every anchor at overlap 0);
- the PSROI pool's interval is open at both ends; the MXNet operator's test
  ``w < -0.5 || w > width - 0.5`` keeps a sample on -0.5 itself;
- the pool's trans gradient is autograd's: zero through the clamp into the
  map, and the right-hand slope at an integer coordinate, where MXNet takes
  the interpolant's slope at the clamped point and a zero slope;
- the flattened pooled features are in (bin row, bin column, channel)
  order, the program's layout of ``offset`` and ``fc_new_1`` (MXNet
  flattens channel first); the weights are the seed's, not a checkpoint.

Parameters are one flat dict {name: tensor} named as the program's
``state_dict``; a batch is a dict of ``image`` u8 [B, 12, H/2, W/2],
``im_info`` [B, 3], ``gt_boxes`` [B, G, 5], ``gt_valid`` [B, G],
``anchor_fg`` and ``anchor_bg`` [B, K], and optionally ``proposals`` [B,
300, 4], the ROIs a step takes instead of its own (the check's, which
judges the program's proposals first and then follows them).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.harness.flops import count_flops, meta_params
from benchmark.reference import detector as D

GROUPS = 4                # deformable groups of res5
DILATION = 2
POOLED, PART, SAMPLES, TRANS_STD = 7, 7, 4, 0.1
POOL_BLOCK = 32           # ROIs gathered at once in the pool
# the layers whose output moves a sample: res5's offset convs, the head's FC
OFFSET_LAYERS = tuple(f"c5.DCNBottleneck_{i}.res5{u}_branch2b_offset"
                      for i, u in enumerate("abc")) + ("offset",)
trainable = D.trainable


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

def _dcn_unit_specs(i: int, u: str, cin: int, proj: bool):
    pre, p, mid, out = f"c5.DCNBottleneck_{i}", f"5{u}", 512, 2048
    s = []
    if proj:
        s.append((f"{pre}.res{p}_branch1.weight", (out, cin, 1, 1)))
    s += [(f"{pre}.res{p}_branch2a.weight", (mid, cin, 1, 1)),
          (f"{pre}.res{p}_branch2b_offset.weight", (GROUPS * 18, mid, 3, 3)),
          (f"{pre}.res{p}_branch2b_offset.bias", (GROUPS * 18,)),
          (f"{pre}.res{p}_branch2b_weight", (mid, mid, 3, 3)),
          (f"{pre}.res{p}_branch2c.weight", (out, mid, 1, 1))]
    for br, ch in (("branch1", out), ("branch2a", mid), ("branch2b", mid),
                   ("branch2c", out)):
        if br != "branch1" or proj:
            s += [(f"{pre}.bn{p}_{br}.{leaf}", (ch,))
                  for leaf in ("gamma", "beta", "moving_mean", "moving_var")]
    return s


def param_specs(arch: dict):
    """[(name, shape)] of every leaf: detector.py's C4 detector with res5
    made deformable and the ``offset`` FC of the deformable PSROI head."""
    s = [(n, sh) for n, sh in D.param_specs(dict(arch, trunk="c4"))
         if not n.startswith("c5.")]
    for i, u in enumerate("abc"):
        s += _dcn_unit_specs(i, u, 1024 if i == 0 else 2048, i == 0)
    return s + D._dense("offset", POOLED * POOLED * 256, POOLED * POOLED * 2)


# --------------------------------------------------------------------------
# the deformable conv and res5
# --------------------------------------------------------------------------

def deform_conv(x, offset, weight, dilation=DILATION, groups=GROUPS):
    """x [N, C, H, W]; offset [N, groups * 2 * 9, H, W]; weight [O, C, 3,
    3] -> [N, O, H, W]: a 3x3 deformable conv, stride 1, padding =
    dilation. Each (group, tap, position) samples its group's channels at
    (h - d + i d + dy, w - d + j d + dx), bilinearly with zero outside."""
    N, C, H, W = x.shape
    O, k = weight.shape[0], weight.shape[-1]
    cg, L = C // groups, H * W
    dev = x.device
    off = offset.reshape(N, groups, k * k, 2, H, W)
    tap = torch.arange(k, device=dev, dtype=torch.float32) * dilation
    ti, tj = tap.repeat_interleave(k), tap.repeat(k)                  # [9]
    hs = torch.arange(H, device=dev, dtype=torch.float32) - dilation
    ws = torch.arange(W, device=dev, dtype=torch.float32) - dilation
    py = hs.view(1, 1, 1, H, 1) + ti.view(1, 1, -1, 1, 1) + off[:, :, :, 0]
    px = ws.view(1, 1, 1, 1, W) + tj.view(1, 1, -1, 1, 1) + off[:, :, :, 1]
    inside = (py > -1) & (py < H) & (px > -1) & (px < W)
    y0, x0 = torch.floor(py), torch.floor(px)
    ly, lx = py - y0, px - x0
    xg = x.reshape(N, groups, cg, L)
    col = 0.0
    for dy, wy in ((0, 1 - ly), (1, ly)):
        for dx, wx in ((0, 1 - lx), (1, lx)):
            yc, xc = y0 + dy, x0 + dx
            ok = (yc >= 0) & (yc <= H - 1) & (xc >= 0) & (xc <= W - 1) & inside
            idx = (yc.clamp(0, H - 1) * W + xc.clamp(0, W - 1)).long()
            v = torch.gather(xg, 3, idx.reshape(N, groups, 1, -1)
                             .expand(N, groups, cg, k * k * L))
            col = col + v * (wy * wx * ok).reshape(N, groups, 1, -1)
    # rows (group, channel, tap) = (channel, tap): the weight's (C, kh, kw)
    col = col.reshape(N, C * k * k, L)
    return (weight.reshape(O, C * k * k) @ col).reshape(N, O, H, W)


def dcn_bottleneck(P, pre, p, x, proj):
    """A res5 unit: 1x1, the deformable 3x3 steered by its offset conv,
    1x1, frozen BatchNorm after each, the shortcut added."""
    sc = (D._bn(P, f"{pre}.bn{p}_branch1", D._conv(P, f"{pre}.res{p}_branch1", x))
          if proj else x)
    y = F.relu(D._bn(P, f"{pre}.bn{p}_branch2a",
                     D._conv(P, f"{pre}.res{p}_branch2a", x)))
    off = D._conv(P, f"{pre}.res{p}_branch2b_offset", y, 1, DILATION, DILATION)
    y = deform_conv(y, off, P[f"{pre}.res{p}_branch2b_weight"])
    y = F.relu(D._bn(P, f"{pre}.bn{p}_branch2b", y))
    y = D._bn(P, f"{pre}.bn{p}_branch2c", D._conv(P, f"{pre}.res{p}_branch2c", y))
    return F.relu(sc + y)


def c4_trunk(P, x, no_grad_through: int = 0):
    """conv1 .. res4b22, detector.py's C4 stages: [N, 1024, h, w]. Stages
    up to ``no_grad_through`` run without gradient (they are frozen)."""
    grad = torch.is_grad_enabled()
    with torch.set_grad_enabled(grad and no_grad_through < 2):
        x = F.relu(D._bn(P, "c4.bn_conv1", F.conv2d(x, P["c4.conv1.weight"],
                                                    None, 2, 3)))
        x = F.max_pool2d(x, 3, 2, 1)
    i = 0
    for stage, (n, _, _, stride) in D._STAGES.items():
        with torch.set_grad_enabled(grad and stage > no_grad_through):
            for u, name in enumerate(D._unit_names(stage, n)):
                x = D._bottleneck(P, f"c4.Bottleneck_{i}", name, x,
                                  stride if u == 0 else 1, 1, u == 0)
                i += 1
    return x


def res5(P, c4):
    """The deformable res5: [N, 2048, h, w]."""
    y = c4
    for u, name in enumerate(D._unit_names(5, 3)):
        y = dcn_bottleneck(P, f"c5.DCNBottleneck_{u}", name, y, u == 0)
    return y


# --------------------------------------------------------------------------
# the deformable PSROI pool and the head
# --------------------------------------------------------------------------

def psroi_pool(feat, rois, trans, scale=1.0 / 16):
    """feat [C, H, W]; rois [R, 4]; trans [R, 2, PART, PART] or None ->
    [R, 7, 7, C]: each bin the mean of its 4 x 4 samples inside."""
    C, H, W = feat.shape
    flat = feat.reshape(C, H * W).t()                                 # [HW, C]
    dev = feat.device
    p = torch.arange(POOLED, device=dev, dtype=torch.float32)
    s = torch.arange(SAMPLES, device=dev, dtype=torch.float32)
    part = torch.floor(p / POOLED * PART).long()
    rois = rois.detach().float()
    out = []
    for lo in range(0, rois.shape[0], POOL_BLOCK):
        r = rois[lo:lo + POOL_BLOCK]
        sw = torch.round(r[:, 0]) * scale - 0.5
        sh = torch.round(r[:, 1]) * scale - 0.5
        rw = ((torch.round(r[:, 2]) + 1.0) * scale - 0.5 - sw).clamp(min=0.1)
        rh = ((torch.round(r[:, 3]) + 1.0) * scale - 0.5 - sh).clamp(min=0.1)
        bw, bh = rw / POOLED, rh / POOLED
        wstart = sw[:, None, None] + p[None, None, :] * bw[:, None, None]
        hstart = sh[:, None, None] + p[None, :, None] * bh[:, None, None]
        if trans is not None:
            t = trans[lo:lo + POOL_BLOCK][:, :, part][:, :, :, part]  # [r,2,7,7]
            wstart = wstart + t[:, 0] * TRANS_STD * rw[:, None, None]
            hstart = hstart + t[:, 1] * TRANS_STD * rh[:, None, None]
        shape = (r.shape[0], POOLED, POOLED, SAMPLES, SAMPLES)        # ph pw ih iw
        h = (hstart[..., None, None] + (s[:, None] * (bh / SAMPLES)[:, None, None, None, None])
             ).expand(shape)
        w = (wstart[..., None, None] + (s[None, :] * (bw / SAMPLES)[:, None, None, None, None])
             ).expand(shape)
        ok = (w > -0.5) & (w < W - 0.5) & (h > -0.5) & (h < H - 0.5)
        hc, wc = h.clamp(0, H - 1), w.clamp(0, W - 1)
        y0, x0 = torch.floor(hc), torch.floor(wc)
        y1, x1 = (y0 + 1).clamp(max=H - 1), (x0 + 1).clamp(max=W - 1)
        ly, lx = hc - y0, wc - x0
        acc = 0.0
        for yy, xx, wt in ((y0, x0, (1 - ly) * (1 - lx)), (y0, x1, (1 - ly) * lx),
                           (y1, x0, ly * (1 - lx)), (y1, x1, ly * lx)):
            v = flat[(yy * W + xx).long().reshape(-1)].reshape(*shape, C)
            acc = acc + v * (wt * ok)[..., None]
        cnt = ok.sum((3, 4)).float()[..., None]
        out.append(torch.where(cnt > 0, acc.sum((3, 4)) / cnt.clamp(min=1),
                               torch.zeros((), device=dev)))
    return torch.cat(out)


def pool(P, feat, rois):
    """The deformable PSROI head's pooled features [R, 7, 7, 256]: a pass
    without trans, the ``offset`` FC on it, the pass its output moves."""
    R = rois.shape[0]
    plain = psroi_pool(feat, rois, None)
    trans = D._linear(P, "offset", plain.reshape(R, -1)).reshape(R, 2, PART, PART)
    return psroi_pool(feat, rois, trans)


def _features(P, image_u8, im_info, a, no_grad_through=0):
    """(c4, the head's map [256, h, w]) of one image."""
    x = D.image_from_u8(image_u8, im_info, a["pixel_means"])
    c4 = c4_trunk(P, x, no_grad_through)
    return c4, F.relu(D._conv(P, "conv_new_1", res5(P, c4)))[0]


def _rpn_levels(P, c4, a):
    """The RPN head on the C4 map: (raw cls [h*w*A, 2], raw bbox [h*w*A, 4]
    in (h, w, a) order, the proposal input [(fg [A, h, w], deltas [A, 4, h,
    w], stride)])."""
    A = int(a["num_anchors"])
    cls, bb = D.rpn_head(P, c4)
    h, w = cls.shape[1:3]
    fg = torch.softmax(cls[0].reshape(h, w, A, 2), -1)[..., 1].permute(2, 0, 1)
    d = bb[0].reshape(h, w, A, 4).permute(2, 3, 0, 1)
    return (cls[0].reshape(-1, 2), bb[0].reshape(-1, 4),
            [(fg.detach(), d.detach(), int(a["rpn_feat_stride"]))])


def _top(sec):
    return (int(sec["rpn_pre_nms_top_n"]), int(sec["rpn_post_nms_top_n"]),
            float(sec["rpn_nms_thresh"]))


# --------------------------------------------------------------------------
# inference
# --------------------------------------------------------------------------

def predict(P, cfg, image_u8, im_info):
    """One request: uint8 s2d image, im_info (h, w, scale) -> detections
    [max_det, 6] (class, score, x1, y1, x2, y2 in original coordinates;
    class -1 pads), as detector.predict's C4 path with this trunk and
    pool."""
    a, t = cfg["arch"], cfg["test"]
    c4, feat = _features(P, image_u8, im_info, a)
    _, _, levels = _rpn_levels(P, c4, a)
    rois = D.proposals(levels, im_info, _top(t),
                       (a["anchor_ratios"], a["anchor_scales"]))
    nongt = int(t["rpn_post_nms_top_n"])
    cls_score, bbox_pred, fc2 = D.head(P, ("fc_new_1", "fc_new_2"),
                                       pool(P, feat, rois), rois, nongt)
    multi, sbox, _ = D.learn_nms(P, cls_score, bbox_pred, rois, fc2, im_info,
                                 int(t["first_n"]), a["bbox_means"],
                                 a["bbox_stds"], float(t["class_score_thresh"]))
    final = multi.mean(dim=2)                                        # [F, C]
    C = final.shape[1]
    flat = torch.where(final > float(t["score_thresh"]), final,
                       torch.full_like(final, D.NEG_INF)).reshape(-1)
    top_s, idx = torch.sort(flat, descending=True, stable=True)
    top_s, idx = top_s[:int(t["max_det"])], idx[:int(t["max_det"])]
    real = top_s > D.NEG_INF / 2
    cls_id = (idx % C + 1).float()
    boxes = (sbox / im_info[2]).reshape(-1, 4)[idx]
    return torch.cat([torch.where(real, cls_id, torch.full_like(cls_id, -1))[:, None],
                      torch.where(real, top_s, torch.zeros_like(top_s))[:, None],
                      boxes * real[:, None]], 1)


# --------------------------------------------------------------------------
# training: the END2END step
# --------------------------------------------------------------------------

def anchors(h, w, a, device):
    """The anchor grid [h * w * A, 4] in (h, w, a) order."""
    stride = int(a["rpn_feat_stride"])
    base = torch.as_tensor(D.base_anchors(stride, a["anchor_ratios"],
                                          a["anchor_scales"]), device=device)
    sy = torch.arange(h, device=device, dtype=torch.float32) * stride
    sx = torch.arange(w, device=device, dtype=torch.float32) * stride
    shift = torch.stack([sx[None, :].expand(h, w), sy[:, None].expand(h, w)] * 2, -1)
    return (shift[:, :, None, :] + base[None, None]).reshape(-1, 4)


def anchor_targets(anc, gt, gt_valid, im_info, u_fg, u_bg, tr):
    """MXNet's assign_anchor: (label [K] in {-1, 0, 1}, regression targets
    [K, 4]). Anchors not wholly inside the image are ignored; an anchor is
    positive at IoU >= 0.7 with some ground truth or as a ground truth's
    best (ties kept), negative under 0.3; at most 128 positives and 256 in
    all are kept, the highest priorities ``u_fg``, ``u_bg`` first."""
    dev = anc.device
    inside = ((anc[:, 0] >= 0) & (anc[:, 1] >= 0) & (anc[:, 2] < im_info[1])
              & (anc[:, 3] < im_info[0]))
    ov = D.iou(anc, gt[:, :4])
    ov = torch.where(gt_valid[None, :] & inside[:, None], ov,
                     torch.full((), -1.0, device=dev))
    max_ov, assign = ov.max(dim=1)
    max_ov = max_ov.clamp(min=0)
    gt_max = ov.max(dim=0).values
    best = ((ov == gt_max[None, :]) & gt_valid[None, :]
            & (gt_max[None, :] > 0)).any(dim=1)
    label = torch.full(max_ov.shape, -1, dtype=torch.long, device=dev)
    label[max_ov < float(tr["rpn_negative_overlap"])] = 0
    label[best | (max_ov >= float(tr["rpn_positive_overlap"]))] = 1
    label[~inside] = -1
    if not bool(gt_valid.any()):
        label[inside] = 0
    n = int(tr["rpn_batch_size"])
    n_fg = int(float(tr["rpn_fg_fraction"]) * n)
    fg = label == 1
    label[fg & ~D._keep_top(fg, u_fg, n_fg, n_fg)] = -1
    bg = label == 0
    n_bg = n - int((label == 1).sum())
    label[bg & ~D._keep_top(bg, u_bg, n_bg, n)] = -1
    tgt = D.bbox_targets(anc, gt[assign, :4], [0.0] * 4, [1.0] * 4)
    return label, torch.where((label == 1)[:, None], tgt, torch.zeros_like(tgt))


def rpn_loss(cls, bbox, label, tgt, tr):
    """Softmax cross-entropy over the kept anchors; smooth L1 (sigma 3) over
    the positives' deltas, divided by the anchors kept an image (256)."""
    box = ((label == 1)[:, None] * D._smooth_l1(bbox - tgt, float(tr["rpn_loss_scale"])))
    return D._ce_valid(cls, label) + box.sum() / int(tr["rpn_batch_size"])


def image_loss(P, cfg, b, i, no_grad_through, rois=None):
    """One image's END2END loss: the RPN's, then the head's on the
    proposals (its own unless ``rois`` [300, 4] are given)."""
    a, tr = cfg["arch"], cfg["train"]
    gt, gv, info = b["gt_boxes"][i], b["gt_valid"][i], b["im_info"][i]
    c4, feat = _features(P, b["image"][i], info, a, no_grad_through)
    cls, bbox, levels = _rpn_levels(P, c4, a)
    h, w = c4.shape[2:]
    label, tgt = anchor_targets(anchors(h, w, a, c4.device), gt, gv, info,
                                b["anchor_fg"][i], b["anchor_bg"][i], tr)
    if rois is None:
        with torch.no_grad():
            rois = D.proposals(levels, info, _top(tr),
                               (a["anchor_ratios"], a["anchor_scales"]))
    return rpn_loss(cls, bbox, label, tgt, tr) + D.head_loss(
        P, cfg, lambda r: pool(P, feat, r), ("fc_new_1", "fc_new_2"), rois,
        gt, gv, info)


def first_proposals(P, cfg, batch):
    """The reference's own training proposals [B, 300, 4] of every image of
    ``batch`` from the weights ``P``."""
    a, tr = cfg["arch"], cfg["train"]
    out = []
    with torch.no_grad():
        for i in range(batch["image"].shape[0]):
            x = D.image_from_u8(batch["image"][i], batch["im_info"][i],
                                a["pixel_means"])
            _, _, levels = _rpn_levels(P, c4_trunk(P, x), a)
            out.append(D.proposals(levels, batch["im_info"][i], _top(tr),
                                   (a["anchor_ratios"], a["anchor_scales"])))
    return torch.stack(out)


def train_steps(P0, cfg, batches, steps):
    """``steps`` END2END SGD steps (momentum, weight decay added to the
    gradient of every trainable leaf, the ``offset`` FC at 0.01 of the
    rate) from the weights ``P0``, one batch a step, the loss the mean of
    its images'. A batch's ``proposals`` replace the step's own. Returns
    (losses [steps], first gradients {leaf: tensor}, final weights {leaf:
    tensor}) of the trainable leaves."""
    tr = cfg["train"]
    P = {k: v.detach().clone() for k, v in P0.items()}
    names = [k for k in P if trainable(k, tr["fixed_params"])]
    for k in names:
        P[k].requires_grad_(True)
    trace = {k: torch.zeros_like(P[k]) for k in names}
    losses, first = [], {}
    no_grad_through = 2 if any(p.startswith("res2") for p in tr["fixed_params"]) else 0
    for step in range(steps):
        b = batches[step]
        B = b["image"].shape[0]
        total = 0.0
        for i in range(B):
            given = b["proposals"][i] if "proposals" in b else None
            loss = image_loss(P, cfg, b, i, no_grad_through, given) / B
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        with torch.no_grad():
            for k in names:
                g = P[k].grad if P[k].grad is not None else torch.zeros_like(P[k])
                if step == 0:
                    first[k] = g.clone()
                trace[k].mul_(tr["momentum"]).add_(g + tr["wd"] * P[k])
                # the head's offset FC trains at 0.01 of the rate (its lr_mult)
                rate = tr["lr"] * (0.01 if "offset" in k.split(".") else 1.0)
                P[k].sub_(rate * trace[k])
                P[k].grad = None
    return losses, first, {k: P[k].detach() for k in names}


# --------------------------------------------------------------------------
# operation counts (benchmark/harness/flops.py: meta tensors, the counter)
# --------------------------------------------------------------------------

def _meta_forward(P, a, H, W, R, nongt, first_n):
    """The products of one image on the ``meta`` device: trunk, RPN head,
    conv_new_1, the ``offset`` FC over R ROIs, the head over R ROIs (the
    pools' samples are no products), the learned-NMS head; returns the
    outputs a loss sums."""
    c4 = c4_trunk(P, torch.empty((1, 3, H, W), device="meta"), 2)
    cls, bb = D.rpn_head(P, c4)
    feat = D._conv(P, "conv_new_1", res5(P, c4))
    pooled, rois = D._head_inputs(R)
    trans = D._linear(P, "offset", pooled.reshape(R, -1))
    score, box, fc2 = D.head(P, ("fc_new_1", "fc_new_2"), pooled, rois, nongt)
    info = torch.tensor([H, W, 1.0], device="meta")
    multi, _, _ = D.learn_nms(P, score[:nongt], box[:nongt], rois[:nongt],
                              fc2[:nongt], info, first_n, a["bbox_means"],
                              a["bbox_stds"])
    return [cls, bb, feat, trans, score, box, multi]


def serve_flops(config) -> int:
    """Operations of one request: trunk with the deformable res5, RPN, the
    offset FC and the head over the test proposals, learned NMS."""
    a, t = config["arch"], config["test"]
    H, W = config["images"]["bucket"]
    P = meta_params(param_specs(a))
    R = int(t["rpn_post_nms_top_n"])
    with torch.no_grad():
        return count_flops(lambda: _meta_forward(P, a, H, W, R, R,
                                                 int(t["first_n"])))


def train_flops(config, rois_per_image: int, gt_per_image: int) -> int:
    """Operations of one image of the END2END step and the backward of
    every trainable leaf's path: the forward of ``_meta_forward`` over the
    proposals and ground-truth rows, and its backward."""
    a, tr = config["arch"], config["train"]
    H, W = config["images"]["bucket"]
    P = meta_params(param_specs(a), lambda n: trainable(n, tr["fixed_params"]))
    R = rois_per_image + gt_per_image
    nongt = min(int(tr["rpn_post_nms_top_n"]), rois_per_image)

    def run():
        outs = _meta_forward(P, a, H, W, R, nongt, int(tr["first_n"]))
        sum(o.sum() for o in outs).backward()
    return count_flops(run)


# --------------------------------------------------------------------------
# calibration (benchmark/tools/calibrate.py, benchmark/tools/offsets.py)
# --------------------------------------------------------------------------

def calibration_outputs(P, cfg, image_u8, im_info):
    """The four prediction layers' outputs over one request, bias removed,
    in the order a request runs them (detector.calibration_outputs' C4
    path with this trunk and pool)."""
    a, t = cfg["arch"], cfg["test"]
    c4, feat = _features(P, image_u8, im_info, a)
    for layer in ("rpn.rpn_cls_score", "rpn.rpn_bbox_pred"):
        hid = torch.relu(D._conv(P, "rpn.rpn_conv_3x3", c4, 1, 1))
        yield layer, D._conv(P, layer, hid).flatten(1) - P[f"{layer}.bias"][:, None]
    _, _, levels = _rpn_levels(P, c4, a)
    rois = D.proposals(levels, im_info, _top(t),
                       (a["anchor_ratios"], a["anchor_scales"]))
    _, _, fc2 = D.head(P, ("fc_new_1", "fc_new_2"), pool(P, feat, rois), rois,
                       rois.shape[0])
    for layer in ("cls_score", "bbox_pred"):
        yield layer, F.linear(fc2, P[f"{layer}.weight"])


def offset_outputs(P, cfg, image_u8, im_info):
    """The offset layers' outputs over one request, bias removed, in the
    order a request runs them (OFFSET_LAYERS): each res5 unit's offset map,
    then the ``offset`` FC's over the request's proposals. Each is computed
    with the weights in ``P`` when asked for, as calibration_outputs'."""
    a, t = cfg["arch"], cfg["test"]
    c4 = c4_trunk(P, D.image_from_u8(image_u8, im_info, a["pixel_means"]))
    y = c4
    for u, name in enumerate(D._unit_names(5, 3)):
        pre = f"c5.DCNBottleneck_{u}"
        hid = F.relu(D._bn(P, f"{pre}.bn{name}_branch2a",
                           D._conv(P, f"{pre}.res{name}_branch2a", y)))
        yield OFFSET_LAYERS[u], F.conv2d(
            hid, P[f"{pre}.res{name}_branch2b_offset.weight"], None, 1,
            DILATION, DILATION)
        y = dcn_bottleneck(P, pre, name, y, u == 0)
    feat = F.relu(D._conv(P, "conv_new_1", y))[0]
    _, _, levels = _rpn_levels(P, c4, a)
    rois = D.proposals(levels, im_info, _top(t),
                       (a["anchor_ratios"], a["anchor_scales"]))
    plain = psroi_pool(feat, rois, None)
    yield "offset", F.linear(plain.reshape(rois.shape[0], -1), P["offset.weight"])
