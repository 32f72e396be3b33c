"""A seeded mini dataset in the COCO layout the drivers read:

    <root>/annotations/instances_<set>.json
    <root>/images/<set>/<set>_NNN.png

Each image is random uint8 noise with a filled rectangle under each of its
one to four ground-truth boxes; boxes carry real COCO category ids (gaps
included) and the first image of every set has one crowd box more. Used by
chip_smoke.py's evaluation phase and the port's driver tests.

    from relation_tpu_torch.tools.mini_coco import write_mini_coco
    arrays = write_mini_coco("data/coco", {"minival2014": [(480, 640)] * 6})
"""

from __future__ import annotations

import json
import os

import numpy as np

# a spread of COCO's ids, gaps between them (12, 26, 45, 66, 83 are absent)
DEFAULT_CAT_IDS = (1, 13, 27, 44, 67, 90)


def write_mini_coco(root: str, sets: dict, seed: int = 0,
                    cat_ids=DEFAULT_CAT_IDS, all_cat_ids=None,
                    png: bool = True) -> dict:
    """Write the annotations of ``sets`` ({image_set: [(h, w), ...]}) under
    ``root``, and the images as PNG files when ``png`` (PIL needed). Boxes
    take classes from ``cat_ids``; the categories listed are
    ``all_cat_ids`` (default ``cat_ids``), so that a dataset can declare
    all 80 COCO classes and use a few. Returns {normalised image path:
    uint8 BGR [h, w, 3]}, the arrays a loader's ``image_loader`` can serve
    in place of the files (``array_loader``)."""
    rng = np.random.RandomState(seed)
    all_cat_ids = list(all_cat_ids or cat_ids)
    cats = [{"id": int(c), "name": f"cat{c}"} for c in sorted(all_cat_ids)]
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    arrays = {}
    ann_id = 1
    for si, (image_set, sizes) in enumerate(sets.items()):
        img_dir = os.path.join(root, "images", image_set)
        os.makedirs(img_dir, exist_ok=True)
        images, anns = [], []
        for i, (h, w) in enumerate(sizes):
            rgb = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            image_id = 1000 * (si + 1) + i + 1
            n_box = rng.randint(1, 5)
            for b in range(n_box + (1 if i == 0 else 0)):
                bw = float(rng.randint(max(w // 10, 4), w // 2))
                bh = float(rng.randint(max(h // 10, 4), h // 2))
                x = float(rng.randint(0, w - int(bw)))
                y = float(rng.randint(0, h - int(bh)))
                rgb[int(y):int(y + bh), int(x):int(x + bw)] = rng.randint(
                    0, 256, 3)
                anns.append({"id": ann_id, "image_id": image_id,
                             "category_id": int(rng.choice(cat_ids)),
                             "bbox": [x, y, bw, bh], "area": bw * bh,
                             "iscrowd": int(b == n_box)})
                ann_id += 1
            name = f"{image_set}_{i:03d}.png"
            path = os.path.join(img_dir, name)
            if png:
                from PIL import Image
                Image.fromarray(rgb).save(path)
            arrays[os.path.normpath(path)] = np.ascontiguousarray(
                rgb[:, :, ::-1])
            images.append({"id": image_id, "file_name": name, "height": h,
                           "width": w})
        with open(os.path.join(root, "annotations",
                               f"instances_{image_set}.json"), "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": cats}, f)
    return arrays


def array_loader(arrays: dict):
    """An ``image_loader`` serving ``write_mini_coco``'s arrays by path."""
    return lambda path: arrays[os.path.normpath(path)]
