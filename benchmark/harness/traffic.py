"""The one traffic generator: images, ground truth and cached proposals made
on the device from the seed, by the parameters of a mix file and the image
sizes of a configuration file.

Every seed gets the same multiset of sizes and counts in another order, so
the work of a run does not depend on the seed; what the seed changes is the
pixels, the boxes' places and shapes, and the order.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _gen(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63))
    return g


def _cycle(values, n: int, g: torch.Generator, device) -> list:
    """``n`` items cycled from ``values`` and put in a seeded order."""
    perm = torch.randperm(n, generator=g, device=device).tolist()
    return [values[i % len(values)] for i in perm]


def images(config: dict, n: int, seed: int, device, sizes=None):
    """n uint8 space-to-depth images [n, 12, H/2, W/2] of the configuration's
    bucket, each holding an image of one of its sizes (zero padding beyond),
    and their im_info [n, 3] = (h, w, scale): ``sizes``, or the
    configuration's cycled in a seeded order. The pixels are a smooth field
    (a coarse grid of random colours, bilinearly upsampled 32x) plus noise."""
    H, W = config["images"]["bucket"]
    g = _gen(seed, 1, device)
    if sizes is None:
        sizes = _cycle(config["images"]["sizes"], n, g, device)
    info = torch.tensor(sizes, dtype=torch.float32, device=device)
    out = torch.empty((n, 12, H // 2, W // 2), dtype=torch.uint8, device=device)
    rows = torch.arange(H, device=device)[:, None]
    cols = torch.arange(W, device=device)[None, :]
    for lo in range(0, n, 16):
        m = min(16, n - lo)
        coarse = torch.rand((m, 3, H // 32, W // 32), generator=g, device=device)
        x = F.interpolate(coarse * 255.0, size=(H, W), mode="bilinear",
                          align_corners=False)
        x = x + 24.0 * torch.randn((m, 3, H, W), generator=g, device=device)
        inside = ((rows[None] < info[lo:lo + m, 0, None, None])
                  & (cols[None] < info[lo:lo + m, 1, None, None]))
        x = (x.clamp(0, 255) * inside[:, None]).round().to(torch.uint8)
        x = x.permute(0, 2, 3, 1).reshape(m, H // 2, 2, W // 2, 2, 3)
        out[lo:lo + m] = x.permute(0, 2, 4, 5, 1, 3).reshape(m, 12, H // 2, W // 2)
    return out, info


def _sizes(n, lo, hi, g, device):
    """n box shapes (w, h): sqrt(area) log-uniform in [lo, hi], aspect
    ratio exp(U(-0.7, 0.7))."""
    u = torch.rand((n, 2), generator=g, device=device)
    side = torch.exp(math.log(lo) + u[:, 0] * (math.log(hi) - math.log(lo)))
    ar = torch.exp((u[:, 1] - 0.5) * 1.4)
    return side * torch.sqrt(ar), side / torch.sqrt(ar)


def _place(w, h, cx, cy, W, H):
    """Boxes of shapes (w, h) centred as near (cx, cy) as lets them lie
    inside a W x H image."""
    w, h = w.clamp(max=W - 2), h.clamp(max=H - 2)
    x1 = (cx - 0.5 * w).clamp(min=0.0).minimum(W - 1 - w)
    y1 = (cy - 0.5 * h).clamp(min=0.0).minimum(H - 1 - h)
    return torch.stack([x1, y1, x1 + w, y1 + h], 1)


def detection_batch(config: dict, mix: dict, n: int, batch: int, seed: int,
                    device):
    """n training images with their ground truth and cached proposals:
    dict(image u8 [n, 12, H/2, W/2], im_info [n, 3], gt_boxes [n, G, 5],
    gt_valid [n, G], rois [n, R, 4], rois_valid [n, R]).

    The shapes of the work are the same for every seed: the pool is cut
    into batches of ``batch`` consecutive templates, the seed orders the
    batches (each batch's own order fixed, so its memory's high-water mark
    is too), and template t, drawn from a fixed
    generator, fixes the image size, the count of ground-truth boxes
    (cycling through the mix's ``gt_counts``), their shapes and every
    proposal's shape, hence every ROI's pyramid level. The seed draws the
    pixels, the boxes' places, the classes and the order.
    A mix ``fg_roi_share`` of the R proposals sit on ground-truth boxes
    (their shape rescaled by exp(N(0, 0.1)) per side, their centre moved
    by N(0, 0.08) of the box), the rest anywhere."""
    fixed = _gen(0, 3, device)
    g = _gen(seed, 2, device)
    blocks = torch.randperm(n // batch, generator=g, device=device).tolist()
    order = [b * batch + j for b in blocks for j in range(batch)]
    sizes = config["images"]["sizes"]
    image, info = images(config, n, seed, device,
                         [sizes[t % len(sizes)] for t in order])
    G = max(mix["gt_counts"])
    R = int(mix["rois_per_image"])
    n_fg = int(round(float(mix["fg_roi_share"]) * R))
    templates = []
    for t in range(n):
        k = mix["gt_counts"][t % len(mix["gt_counts"])]
        templates.append((k, _sizes(k, 24.0, 480.0, fixed, device),
                          torch.randn((n_fg, 4), generator=fixed, device=device),
                          _sizes(R - n_fg, 16.0, 640.0, fixed, device)))
    gt = torch.zeros((n, G, 5), device=device)
    gv = torch.zeros((n, G), dtype=torch.bool, device=device)
    rois = torch.zeros((n, R, 4), device=device)
    for i in range(n):
        H, W = float(info[i, 0]), float(info[i, 1])
        k, (gw, gh), jit, (bw, bh) = templates[order[i]]
        u = torch.rand((k + R, 2), generator=g, device=device)
        boxes = _place(gw, gh, u[:k, 0] * W, u[:k, 1] * H, W, H)
        gt[i, :k, :4] = boxes
        gt[i, :k, 4] = torch.randint(1, int(config["arch"]["num_classes"]),
                                     (k,), generator=g, device=device).float()
        gv[i, :k] = True
        pick = torch.arange(n_fg, device=device) % k
        base = boxes[pick]
        w0, h0 = base[:, 2] - base[:, 0], base[:, 3] - base[:, 1]
        cx = base[:, 0] + 0.5 * w0 + 0.08 * w0 * jit[:, 0]
        cy = base[:, 1] + 0.5 * h0 + 0.08 * h0 * jit[:, 1]
        fg = _place(w0 * torch.exp(0.1 * jit[:, 2]), h0 * torch.exp(0.1 * jit[:, 3]),
                    cx, cy, W, H)
        bg = _place(bw, bh, u[k + n_fg:, 0] * W, u[k + n_fg:, 1] * H, W, H)
        allr = torch.cat([fg, bg])
        rois[i] = allr[torch.randperm(R, generator=g, device=device)]
    return {"image": image, "im_info": info, "gt_boxes": gt, "gt_valid": gv,
            "rois": rois,
            "rois_valid": torch.ones((n, R), dtype=torch.bool, device=device)}


def split(batch: dict, size: int) -> list:
    """Consecutive batches of ``size`` images."""
    n = batch["image"].shape[0]
    return [{k: v[lo:lo + size] for k, v in batch.items()}
            for lo in range(0, n - size + 1, size)]
