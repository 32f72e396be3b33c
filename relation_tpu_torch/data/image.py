"""Host-side image pipeline (port of relation_tpu/data/image.py): load,
resize, mean-subtract, flip, bucket-pad, and the s2d planar relayout.

Semantics of the reference (lib/utils/image.py:18-196):
- resize so the short side hits SCALES[0][0] without the long side exceeding
  SCALES[0][1] (min(target/short, max/long) scaling);
- pixels kept in BGR channel order, PIXEL_MEANS (BGR) subtracted;
- a horizontal flip flips boxes with the +1 convention (x1' = W - x2 - 1).

Every image is zero-padded into a fixed (H, W) bucket; im_info carries the
true (h, w, scale).

The resize differs from the JAX package's in one way: it always resizes.
The JAX package resizes with PIL's BILINEAR and, where PIL is missing,
returns the image unresized while still reporting the scale. Here the
resize is ``torch.nn.functional.interpolate`` (bilinear with antialias, the
filter PIL's BILINEAR applies when it shrinks or enlarges) on the CPU, with
or without PIL. It is bit-equal to PIL on most sizes and one grey level off
on a fraction of a percent of the pixels on others
(tests/test_torch_data.py states the band it finds). PIL is needed to
decode a file only.
"""

from __future__ import annotations

import numpy as np
import torch

try:
    from PIL import Image
    _HAS_PIL = True
except ImportError:          # pragma: no cover
    _HAS_PIL = False


def load_image_bgr(path: str) -> np.ndarray:
    """Read an image file -> uint8 [H, W, 3] BGR (uint8 through the resize;
    the f32 cast comes at the mean subtraction, on the host or the card)."""
    if not _HAS_PIL:
        raise RuntimeError("PIL unavailable")
    with Image.open(path) as im:
        rgb = np.asarray(im.convert("RGB"), dtype=np.uint8)
    return rgb[:, :, ::-1]


def resize_im(im: np.ndarray, target_size: int, max_size: int):
    """Scale so the short side == target_size unless the long side would
    exceed max_size (reference lib/utils/image.py resize). Returns (uint8
    [h', w', C], scale)."""
    h, w = im.shape[:2]
    scale = float(target_size) / min(h, w)
    if round(scale * max(h, w)) > max_size:
        scale = float(max_size) / max(h, w)
    out_hw = (int(round(h * scale)), int(round(w * scale)))
    x = torch.from_numpy(np.ascontiguousarray(im.astype(np.uint8)))
    x = x.permute(2, 0, 1)[None].contiguous(memory_format=torch.channels_last)
    out = torch.nn.functional.interpolate(x, size=out_hw, mode="bilinear",
                                          antialias=True, align_corners=False)
    return np.ascontiguousarray(out[0].permute(1, 2, 0).numpy()), scale


def transform(im_bgr: np.ndarray, pixel_means) -> np.ndarray:
    """Mean subtraction; stays HWC/BGR float32."""
    return im_bgr.astype(np.float32) - np.asarray(pixel_means, np.float32)


def flip_boxes(boxes: np.ndarray, width: int) -> np.ndarray:
    """Horizontal flip with the +1 convention (reference
    lib/dataset/imdb.py:236-239)."""
    out = boxes.copy()
    out[:, 0] = width - boxes[:, 2] - 1
    out[:, 2] = width - boxes[:, 0] - 1
    return out


def pick_bucket(h: int, w: int, buckets) -> tuple[int, int]:
    """Smallest (H, W) bucket that fits; falls back to the largest."""
    for bh, bw in sorted(buckets):
        if h <= bh and w <= bw:
            return (bh, bw)
    return tuple(sorted(buckets)[-1])


def pad_to_bucket(im: np.ndarray, bucket: tuple[int, int]) -> np.ndarray:
    """Zero-pad ``im`` [h, w, ...] to the bucket; never crops (a crop would
    leave ground-truth boxes pointing off the image)."""
    bh, bw = bucket
    h, w = im.shape[:2]
    if h > bh or w > bw:
        raise ValueError(
            f"resized image ({h}x{w}) exceeds the largest image bucket "
            f"({bh}x{bw}); extend cfg.TPU.IMAGE_BUCKETS to cover "
            f"cfg.SCALES (a silent crop would corrupt detections/gt)")
    out = np.zeros((bh, bw) + im.shape[2:], dtype=im.dtype)
    out[:h, :w] = im
    return out


def prepare_image(im_bgr: np.ndarray, target_size: int, max_size: int,
                  pixel_means, buckets, flip: bool = False,
                  boxes: np.ndarray | None = None):
    """Flip (optional), resize, mean-subtract, bucket-pad. Returns (image
    [bH, bW, 3], im_info [3], boxes scaled and flipped, or None). The flip
    comes before the resize, and the boxes flip at the original width.

    ``pixel_means=None`` keeps the image uint8 (no mean subtraction): the
    predictor and the train step subtract the means on the card
    (core/predictor.py::_image_from_u8), exactly."""
    if flip:
        im_bgr = im_bgr[:, ::-1, :]
    im, scale = resize_im(im_bgr, target_size, max_size)
    h, w = im.shape[:2]
    if pixel_means is not None:
        im = transform(im, pixel_means)
    im = pad_to_bucket(im, pick_bucket(h, w, buckets))
    im_info = np.asarray([h, w, scale], np.float32)
    out_boxes = None
    if boxes is not None:
        out_boxes = boxes.copy().astype(np.float32)
        if flip:
            out_boxes[:, :4] = flip_boxes(out_boxes[:, :4], int(im_bgr.shape[1]))
        out_boxes[:, :4] *= scale
    return im, im_info, out_boxes


def to_s2d_planar(im_hwc: np.ndarray) -> np.ndarray:
    """Space-to-depth on the host: [H, W, C] -> [4C, H/2, W/2], channel order
    (row phase, column phase, c), the stem's input layout. Bucket H and W
    are even."""
    H, W, C = im_hwc.shape
    return np.ascontiguousarray(
        im_hwc.reshape(H // 2, 2, W // 2, 2, C)
        .transpose(1, 3, 4, 0, 2)
        .reshape(4 * C, H // 2, W // 2))


def batch_image_hw(batch_image) -> tuple[int, int]:
    """Original (H, W) of a batched image in either loader layout: s2d
    planar [B, 12, H/2, W/2] or NHWC [B, H, W, 3]."""
    if (batch_image.ndim == 4 and batch_image.shape[1] == 12
            and batch_image.shape[-1] != 3):
        return batch_image.shape[2] * 2, batch_image.shape[3] * 2
    return batch_image.shape[1], batch_image.shape[2]


def image_hw(image) -> tuple[int, int]:
    """Original (H, W) of one image: s2d planar [12, H/2, W/2] or HWC
    [H, W, 3]."""
    if image.ndim == 3 and image.shape[0] == 12 and image.shape[-1] != 3:
        return image.shape[1] * 2, image.shape[2] * 2
    return image.shape[0], image.shape[1]
