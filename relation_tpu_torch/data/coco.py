"""COCO dataset: annotation loading -> roidb, and detection-result export
(port of relation_tpu/data/coco.py; a direct JSON parser in place of the
reference's pycocotools-backed ``coco(IMDB)``, lib/dataset/coco.py:60-282).

roidb entry (reference lib/dataset/imdb.py + coco.py:128-183):
  {image, image_id, height, width, boxes [G, 4] float32, gt_classes [G]
   int32, iscrowd [G] bool, flipped bool}
Boxes are (x1, y1, x2, y2) clipped inside the image; COCO xywh converts with
x2 = x1 + max(0, w - 1) (coco.py:160-166). COCO's category ids have gaps;
class k (1-based, 0 is the background) is the k-th smallest id.
"""

from __future__ import annotations

import json
import os

import numpy as np

from relation_tpu_torch.data.image import flip_boxes

# the 80 COCO detection categories in the reference's class order (ids
# ascending, as pycocotools getCatIds returns them)
COCO_CAT_IDS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19,
                20, 21, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38,
                39, 40, 41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55,
                56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 67, 70, 72, 73, 74, 75,
                76, 77, 78, 79, 80, 81, 82, 84, 85, 86, 87, 88, 89, 90]


class CocoDataset:
    """Minimal COCO detection dataset with the reference's roidb protocol."""

    def __init__(self, annotation_file: str, image_root: str = "",
                 use_crowd: bool = False):
        with open(annotation_file) as f:
            data = json.load(f)
        self.image_root = image_root
        cat_ids = sorted(c["id"] for c in data.get("categories", [])) or COCO_CAT_IDS
        self.cat_ids = cat_ids
        self.cat_to_class = {cid: i + 1 for i, cid in enumerate(cat_ids)}
        self.class_to_cat = {v: k for k, v in self.cat_to_class.items()}
        self.num_classes = len(cat_ids) + 1      # + background
        names = {c["id"]: c.get("name", str(c["id"]))
                 for c in data.get("categories", [])}
        self.class_names = [names.get(cid, str(cid)) for cid in cat_ids]

        self.images = {im["id"]: im for im in data["images"]}
        anns_by_image: dict[int, list] = {}
        for ann in data.get("annotations", []):
            anns_by_image.setdefault(ann["image_id"], []).append(ann)
        self._anns_by_image = anns_by_image
        self.image_ids = sorted(self.images)
        self.use_crowd = use_crowd

    def roidb_entry(self, image_id: int) -> dict:
        im = self.images[image_id]
        h, w = im["height"], im["width"]
        boxes, classes, crowd = [], [], []
        for ann in self._anns_by_image.get(image_id, []):
            if ann.get("ignore", 0):
                continue
            x, y, bw, bh = ann["bbox"]
            # xywh -> x1y1x2y2 clipped (reference coco.py:158-166)
            x1 = max(0.0, x)
            y1 = max(0.0, y)
            x2 = min(w - 1.0, x1 + max(0.0, bw - 1.0))
            y2 = min(h - 1.0, y1 + max(0.0, bh - 1.0))
            if ann.get("area", bw * bh) > 0 and x2 >= x1 and y2 >= y1:
                # crowd boxes stay, flagged for the evaluator; the train
                # loader drops them (the reference gives them class -1,
                # coco.py:170-173)
                boxes.append([x1, y1, x2, y2])
                classes.append(self.cat_to_class[ann["category_id"]])
                crowd.append(bool(ann.get("iscrowd", 0)))
        return {
            "image": os.path.join(self.image_root, im["file_name"]),
            "image_id": image_id,
            "height": h, "width": w,
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "gt_classes": np.asarray(classes, np.int32),
            "iscrowd": np.asarray(crowd, bool),
            "flipped": False,
        }

    def roidb(self, flip: bool = False) -> list[dict]:
        """The full roidb; ``flip`` appends flipped copies (reference
        imdb.append_flipped_images, imdb.py:219-255)."""
        entries = [self.roidb_entry(i) for i in self.image_ids]
        if flip:
            flipped = []
            for e in entries:
                fe = dict(e)
                fe["boxes"] = (flip_boxes(e["boxes"], e["width"])
                               if len(e["boxes"]) else e["boxes"])
                fe["flipped"] = True
                flipped.append(fe)
            entries = entries + flipped
        return entries

    def detections_to_json(self, dets_per_image: dict[int, np.ndarray]) -> list:
        """dets [N, 6] rows (class, score, x1, y1, x2, y2) in original
        coordinates -> COCO results records (xywh, category_id), reference
        coco.py:244-263."""
        out = []
        for image_id, dets in dets_per_image.items():
            for row in np.asarray(dets):
                cls = int(row[0])
                if cls < 1:
                    continue
                x1, y1, x2, y2 = row[2:6]
                out.append({
                    "image_id": int(image_id),
                    "category_id": self.class_to_cat[cls],
                    "bbox": [float(x1), float(y1),
                             float(x2 - x1 + 1), float(y2 - y1 + 1)],
                    "score": float(row[1]),
                })
        return out


def coco_dataset(root: str, image_set: str) -> CocoDataset:
    """One image set of the COCO layout the drivers read:
    <root>/annotations/instances_<image_set>.json, images under
    <root>/images/<image_set>/."""
    return CocoDataset(
        os.path.join(root, "annotations", f"instances_{image_set}.json"),
        os.path.join(root, "images", image_set))


def filter_roidb(roidb: list[dict]) -> list[dict]:
    """Drop images without a non-crowd ground-truth box (reference
    lib/utils/load_data.py:45-56)."""
    return [e for e in roidb if len(e["boxes"]) > 0 and (~e["iscrowd"]).any()]
