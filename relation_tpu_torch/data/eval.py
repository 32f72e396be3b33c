"""COCO-style detection evaluation, bbox mAP (port of relation_tpu/data/eval.py):
implemented from the metric's definition, as the reference vendors
pycocotools' cocoeval (lib/dataset/pycocotools/cocoeval.py) for the purpose.
The matching runs in the native library (utils/native.py::coco_match_image)
where it is built, else in the pure-Python ``_match_image``; both give the
same results.

Protocol implemented (matching the published COCOeval bbox semantics):
- IoU thresholds 0.50:0.05:0.95; 101-point interpolated precision
- area ranges all/small/medium/large on the annotation area field
- maxDets 1/10/100 (matching runs once at 100; smaller maxDets slice the
  per-image score-sorted prefix, exactly cocoeval's accumulate [0:maxDet]);
  greedy score-ordered matching, non-ignored gts first; a det may fall back to
  an ignored/crowd gt; crowd IoU = intersection/det-area
- ignored dets (matched to ignored gt, or unmatched & out of area range) are
  dropped from both TP and FP

Outputs the standard 12 summary numbers (AP, AP50, AP75, APs, APm, APl, AR@1,
AR@10, AR@100, ARs, ARm, ARl) plus a per-class AP table (the reference prints
one via _print_detection_metrics, lib/dataset/coco.py:262-282).
"""

from __future__ import annotations

import numpy as np

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def _iou_matrix(dets_xywh: np.ndarray, gts_xywh: np.ndarray,
                iscrowd: np.ndarray) -> np.ndarray:
    """[D, G] IoU; for crowd gt, intersection / det area."""
    D, G = len(dets_xywh), len(gts_xywh)
    out = np.zeros((D, G))
    if D == 0 or G == 0:
        return out
    dx1, dy1 = dets_xywh[:, 0], dets_xywh[:, 1]
    dx2, dy2 = dx1 + dets_xywh[:, 2], dy1 + dets_xywh[:, 3]
    gx1, gy1 = gts_xywh[:, 0], gts_xywh[:, 1]
    gx2, gy2 = gx1 + gts_xywh[:, 2], gy1 + gts_xywh[:, 3]
    d_area = dets_xywh[:, 2] * dets_xywh[:, 3]
    g_area = gts_xywh[:, 2] * gts_xywh[:, 3]
    iw = np.maximum(0, np.minimum(dx2[:, None], gx2[None]) -
                    np.maximum(dx1[:, None], gx1[None]))
    ih = np.maximum(0, np.minimum(dy2[:, None], gy2[None]) -
                    np.maximum(dy1[:, None], gy1[None]))
    inter = iw * ih
    denom = np.where(iscrowd[None, :], d_area[:, None],
                     d_area[:, None] + g_area[None, :] - inter)
    return np.where(denom > 0, inter / np.maximum(denom, 1e-12), 0.0)


def _match_image(det_boxes, det_scores, gt_boxes, gt_ignore, gt_crowd,
                 det_areas, area_rng, max_det):
    """Greedy COCO matching for one (image, class). Returns per-IoU-thr arrays
    (det_matched [T, D], det_ignored [T, D]) plus gt count after area-ignore."""
    order = np.argsort(-det_scores, kind="mergesort")[:max_det]
    det_boxes = det_boxes[order]
    det_areas = det_areas[order]
    D = len(det_boxes)
    # gts: non-ignored first (cocoeval sorts by _ignore)
    gt_order = np.argsort(gt_ignore, kind="mergesort")
    gt_boxes = gt_boxes[gt_order]
    gt_ignore = gt_ignore[gt_order]
    gt_crowd = gt_crowd[gt_order]
    G = len(gt_boxes)
    ious = _iou_matrix(det_boxes, gt_boxes, gt_crowd)

    T = len(IOU_THRS)
    matched = np.zeros((T, D), bool)
    ignored = np.zeros((T, D), bool)
    for ti, thr in enumerate(IOU_THRS):
        gt_used = np.zeros(G, bool)
        for d in range(D):
            best_iou = min(thr, 1 - 1e-10)
            best_g = -1
            for g in range(G):
                if gt_used[g] and not gt_crowd[g]:
                    continue
                # once we hit ignored gts, stop if we already have a real match
                if best_g > -1 and not gt_ignore[best_g] and gt_ignore[g]:
                    break
                if ious[d, g] < best_iou:
                    continue
                best_iou = ious[d, g]
                best_g = g
            if best_g >= 0:
                gt_used[best_g] = True
                matched[ti, d] = True
                ignored[ti, d] = gt_ignore[best_g]
        out_of_area = (det_areas < area_rng[0]) | (det_areas > area_rng[1])
        ignored[ti] |= (~matched[ti]) & out_of_area
    num_gt = int((~gt_ignore).sum())
    return order, matched, ignored, num_gt


class CocoEvaluator:
    """Accumulate detections and compute bbox AP against a CocoDataset."""

    def __init__(self, dataset):
        self.ds = dataset
        # gt per (image, class): xywh boxes, area, iscrowd
        self._gt = {}
        for img_id in dataset.image_ids:
            for ann in dataset._anns_by_image.get(img_id, []):
                cls = dataset.cat_to_class[ann["category_id"]]
                rec = self._gt.setdefault((img_id, cls), [])
                rec.append((ann["bbox"], ann.get("area",
                            ann["bbox"][2] * ann["bbox"][3]),
                            bool(ann.get("iscrowd", 0))))
        self.dets = {}       # (img_id, cls) -> list of (score, xywh)

    def add_detections(self, image_id: int, dets: np.ndarray):
        """dets: [N, 6] rows (class, score, x1, y1, x2, y2), original coords.

        Stored as per-(image, class) chunks of (scores [k], xywh [k, 4]) —
        vectorized class grouping (a stable sort preserves within-class
        insertion order, the tie-break cocoeval inherits from detection
        order)."""
        dets = np.asarray(dets, float).reshape(-1, 6)
        cls = dets[:, 0].astype(np.int64)
        keep = cls >= 1
        dets, cls = dets[keep], cls[keep]
        if not len(dets):
            return
        order = np.argsort(cls, kind="stable")
        dets, cls = dets[order], cls[order]
        xywh = np.stack([dets[:, 2], dets[:, 3],
                         dets[:, 4] - dets[:, 2] + 1,
                         dets[:, 5] - dets[:, 3] + 1], axis=1)
        bounds = np.flatnonzero(np.diff(cls)) + 1
        for s, b, c in zip(np.split(dets[:, 1], bounds),
                           np.split(xywh, bounds),
                           cls[np.concatenate([[0], bounds])]):
            self.dets.setdefault((image_id, int(c)), []).append((s, b))

    def summarize(self, max_det: int = 100,
                  max_dets: tuple = (1, 10, 100)) -> dict:
        T = len(IOU_THRS)
        R = len(REC_THRS)
        classes = sorted(set(c for (_, c) in
                             list(self._gt.keys()) + list(self.dets.keys())))
        results = {}
        # precision at the largest maxDet (all AP stats use maxDets=100);
        # recall at every maxDet (AR@1 / AR@10 / AR@100 / AR S,M,L)
        prec_all = {k: np.full((T, R, len(classes)), np.nan) for k in AREA_RNG}
        rec_all = {(k, m): np.full((T, len(classes)), np.nan)
                   for k in AREA_RNG for m in max_dets}

        area_keys = list(AREA_RNG)
        area_arr = np.ascontiguousarray([AREA_RNG[k] for k in area_keys], float)
        thrs_arr = np.ascontiguousarray(IOU_THRS, float)
        from relation_tpu_torch.utils.native import coco_match_image

        # pre-stage every (image, class) pair ONCE as typed contiguous numpy
        # (score-sorted, capped at max_det) and index the pairs per class in
        # ds.image_ids order — only pairs with gts or dets are visited (an
        # empty pair appends empty arrays and ngt 0; at minival scale the
        # vast majority of the 5000 x 80 grid is empty)
        img_rank = {im: i for i, im in enumerate(self.ds.image_ids)}
        det_np, gt_np = {}, {}
        keys_by_class: dict = {}
        for key, chunks in self.dets.items():
            if key[0] not in img_rank:
                continue
            s = np.concatenate([c[0] for c in chunks])
            b = np.concatenate([c[1] for c in chunks])
            order = np.argsort(-s, kind="mergesort")[:max_det]
            b = np.ascontiguousarray(b[order])
            det_np[key] = (s[order], b, b[:, 2] * b[:, 3])
            keys_by_class.setdefault(key[1], set()).add(key[0])
        for key, gts in self._gt.items():
            if key[0] not in img_rank:
                continue
            gt_np[key] = (
                np.asarray([g[0] for g in gts], float).reshape(-1, 4),
                np.ascontiguousarray([g[1] for g in gts], float),
                np.ascontiguousarray([g[2] for g in gts], np.uint8))
            keys_by_class.setdefault(key[1], set()).add(key[0])
        _d_empty = (np.zeros(0), np.zeros((0, 4)), np.zeros(0))
        _g_empty = (np.zeros((0, 4)), np.zeros(0), np.zeros(0, np.uint8))

        for ci, cls in enumerate(classes):
            per_area_scores = {k: [] for k in AREA_RNG}
            per_area_matched = {k: [] for k in AREA_RNG}
            per_area_ignored = {k: [] for k in AREA_RNG}
            per_area_ngt = {k: 0 for k in AREA_RNG}
            imgs = sorted(keys_by_class.get(cls, ()), key=img_rank.__getitem__)
            for img_id in imgs:
                gt_boxes, gt_area, gt_crowd = gt_np.get((img_id, cls), _g_empty)
                det_scores, det_boxes, det_areas = det_np.get((img_id, cls),
                                                              _d_empty)
                # ONE IoU matrix per (image, class) — the native matcher runs
                # all 4 area ranges x 10 thresholds in a single call
                # (cocoeval computes IoU once per pair the same way,
                # cocoeval.py:271-378)
                nat = coco_match_image(
                    _iou_matrix(det_boxes, gt_boxes, gt_crowd.astype(bool)),
                    gt_area, gt_crowd, det_areas, thrs_arr, area_arr)
                if nat is not None:
                    matched_a, ignored_a, ngt_a = nat
                    for ai, k in enumerate(area_keys):
                        per_area_scores[k].append(det_scores)
                        per_area_matched[k].append(matched_a[ai])
                        per_area_ignored[k].append(ignored_a[ai])
                        per_area_ngt[k] += int(ngt_a[ai])
                    continue
                for k, rng in AREA_RNG.items():   # pure-Python fallback
                    crowd_b = gt_crowd.astype(bool)
                    gt_ignore = crowd_b | (gt_area < rng[0]) | (gt_area > rng[1])
                    order, matched, ignored, ngt = _match_image(
                        det_boxes, det_scores, gt_boxes, gt_ignore, crowd_b,
                        det_areas, rng, max_det)
                    per_area_scores[k].append(det_scores[order])
                    per_area_matched[k].append(matched)
                    per_area_ignored[k].append(ignored)
                    per_area_ngt[k] += ngt

            for k in AREA_RNG:
                ngt = per_area_ngt[k]
                if ngt == 0:
                    continue
                for m in max_dets:
                    # cocoeval accumulate: slice each image's score-sorted det
                    # prefix [0:maxDet] of the SAME maxDets[-1] matching
                    # (cocoeval.py:321-327) — greedy matching is prefix-stable
                    scores = np.concatenate(
                        [s[:m] for s in per_area_scores[k]])
                    matched = np.concatenate(
                        [a[:, :m] for a in per_area_matched[k]], axis=1)
                    ignored = np.concatenate(
                        [a[:, :m] for a in per_area_ignored[k]], axis=1)
                    order = np.argsort(-scores, kind="mergesort")
                    matched = matched[:, order]
                    ignored = ignored[:, order]
                    for ti in range(T):
                        keep = ~ignored[ti]
                        tp = np.cumsum(matched[ti][keep])
                        fp = np.cumsum(~matched[ti][keep])
                        if len(tp) == 0:
                            rec_all[(k, m)][ti, ci] = 0.0
                            if m == max_det:
                                prec_all[k][ti, :, ci] = 0.0
                            continue
                        rc = tp / ngt
                        rec_all[(k, m)][ti, ci] = rc[-1]
                        if m != max_det:
                            continue
                        pr = tp / np.maximum(tp + fp, 1e-12)
                        # monotone-from-right interpolation
                        pr = np.maximum.accumulate(pr[::-1])[::-1]
                        idx = np.searchsorted(rc, REC_THRS, side="left")
                        p = np.zeros(R)
                        ok = idx < len(pr)
                        p[ok] = pr[idx[ok]]
                        prec_all[k][ti, :, ci] = p

        def ap(area, thr=None):
            p = prec_all[area]
            if thr is not None:
                p = p[IOU_THRS == thr]
            return float(np.nanmean(p)) if not np.all(np.isnan(p)) else float("nan")

        def ar(area, m):
            r = rec_all[(area, m)]
            return float(np.nanmean(r)) if not np.all(np.isnan(r)) else float("nan")

        results["AP"] = ap("all")
        results["AP50"] = ap("all", 0.5)
        results["AP75"] = ap("all", 0.75)
        results["APs"] = ap("small")
        results["APm"] = ap("medium")
        results["APl"] = ap("large")
        results["AR1"] = ar("all", 1)
        results["AR10"] = ar("all", 10)
        results["AR100"] = ar("all", 100)
        results["ARs"] = ar("small", 100)
        results["ARm"] = ar("medium", 100)
        results["ARl"] = ar("large", 100)
        # per-class AP (IoU .50:.95, all areas, maxDets=100) keyed by class
        # index — the reference's per-category table (coco.py:262-282)
        results["per_class"] = {
            int(cls): (float(np.nanmean(prec_all["all"][:, :, ci]))
                       if not np.all(np.isnan(prec_all["all"][:, :, ci]))
                       else float("nan"))
            for ci, cls in enumerate(classes)}
        return results


def format_coco_summary(results: dict, class_names=None) -> str:
    """The 12-line COCOeval summary block + per-category AP table, formatted
    exactly like cocoeval.summarize (cocoeval.py:377-409) and
    _print_detection_metrics (lib/dataset/coco.py:262-282)."""
    row = (" {:<18} ({}) @[ IoU={:<9} | area={:>6} | "
           "maxDets={:>3} ] = {:.3f}")
    lines = []
    if results.get("per_class"):
        lines.append("~~~~ Mean and per-category AP @ IoU=0.50,0.95] ~~~~")
        vals = [v for v in results["per_class"].values() if v == v]
        lines.append("%-15s %5.1f" % ("all", 100 * (np.mean(vals) if vals
                                                    else float("nan"))))
        for cls, v in sorted(results["per_class"].items()):
            name = (class_names[cls - 1] if class_names and
                    0 < cls <= len(class_names) else str(cls))
            lines.append("%-15s %5.1f" % (name, 100 * v))
        lines.append("~~~~ Summary metrics ~~~~")
    for key, title, typ, iou, area, md in (
            ("AP", "Precision", "AP", "0.50:0.95", "all", 100),
            ("AP50", "Precision", "AP", "0.50", "all", 100),
            ("AP75", "Precision", "AP", "0.75", "all", 100),
            ("APs", "Precision", "AP", "0.50:0.95", "small", 100),
            ("APm", "Precision", "AP", "0.50:0.95", "medium", 100),
            ("APl", "Precision", "AP", "0.50:0.95", "large", 100),
            ("AR1", "Recall", "AR", "0.50:0.95", "all", 1),
            ("AR10", "Recall", "AR", "0.50:0.95", "all", 10),
            ("AR100", "Recall", "AR", "0.50:0.95", "all", 100),
            ("ARs", "Recall", "AR", "0.50:0.95", "small", 100),
            ("ARm", "Recall", "AR", "0.50:0.95", "medium", 100),
            ("ARl", "Recall", "AR", "0.50:0.95", "large", 100)):
        lines.append(row.format("Average " + title, typ, iou, area, md,
                                results.get(key, float("nan"))))
    return "\n".join(lines)
