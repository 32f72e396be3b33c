"""Host-side batch loaders with threaded prefetching (port of
relation_tpu/data/loader.py; reference AnchorLoader / TestLoader,
core/loader.py:25-607, and PrefetchingIterV2's decode threads,
lib/utils/PrefetchingIter.py:19-150).

The anchor targets are computed in the train step on the card, so the host
loader only decodes, resizes, flips, pads and stacks. Images land in fixed
(H, W) buckets; ground-truth boxes are padded to TPU.MAX_GT rows with a
validity mask. With TRAIN.ASPECT_GROUPING, batches group wide and tall
images (reference loader.py:496-513). The order of a seed is the JAX
package's: the same ``np.random.RandomState(seed)`` draws the same
permutations.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from relation_tpu_torch.data.image import (load_image_bgr, prepare_image,
                                          to_s2d_planar)


class TrainLoader:
    """Yields dict(image [B,H,W,3] or s2d [B,12,H/2,W/2], im_info [B,3],
    gt_boxes [B,G,5], gt_valid [B,G]) batches, one bucket per batch.

    Decode/resize/flip/s2d run per image in a ``num_workers``-thread pool
    with a bounded in-order window of ``num_prefetch`` batches (the
    reference's PrefetchingIterV2 decode threads feeding AnchorLoader,
    core/loader.py:561-588); the batch is stacked on the consumer side.
    With TPU.H2D_UINT8 (default) images stay uint8 on the host, a quarter
    of the bytes to copy to the card, and the train step does the exact
    mean subtraction and pad zeroing there (core/predictor.py::
    _image_from_u8). ``image_loader(path)`` -> uint8 BGR [H, W, 3] replaces
    the file decode."""

    def __init__(self, roidb, cfg, batch_size: int, seed: int = 0,
                 num_prefetch: int = 4, num_workers: int = 4,
                 image_loader=load_image_bgr):
        self.roidb = list(roidb)
        self.cfg = cfg
        self.batch_size = batch_size
        self.rng = np.random.RandomState(seed)
        self.buckets = [tuple(b) for b in cfg.TPU.IMAGE_BUCKETS]
        self.max_gt = int(cfg.TPU.MAX_GT)
        self.num_prefetch = num_prefetch
        self.num_workers = num_workers
        self.image_loader = image_loader
        self._order = None

    def __len__(self):
        return len(self.roidb) // self.batch_size

    def _shuffled_order(self):
        idx = np.arange(len(self.roidb))
        if self.cfg.TRAIN.ASPECT_GROUPING:
            # group wide vs tall (reference loader.py:496-513) so same-bucket
            # images batch together
            aspect = np.asarray([e["width"] / e["height"] for e in self.roidb])
            horz = idx[aspect >= 1]
            vert = idx[aspect < 1]
            self.rng.shuffle(horz)
            self.rng.shuffle(vert)
            idx = np.concatenate([horz, vert])
            blocks = [idx[i:i + self.batch_size]
                      for i in range(0, len(idx) - self.batch_size + 1,
                                     self.batch_size)]
            self.rng.shuffle(blocks)
            return np.concatenate(blocks) if blocks else idx[:0]
        if self.cfg.TRAIN.SHUFFLE:
            self.rng.shuffle(idx)
        return idx

    def _load_one(self, entry):
        """Decode+resize+flip (+s2d) ONE image — the worker-thread unit. PIL
        decode and the numpy relayout release the GIL, so workers overlap."""
        im = self.image_loader(entry["image"])
        flip = bool(entry.get("flipped", False))
        boxes = entry["boxes"]
        keep = ~entry["iscrowd"] if "iscrowd" in entry else np.ones(len(boxes), bool)
        gt5 = np.concatenate([boxes[keep],
                              entry["gt_classes"][keep, None].astype(np.float32)],
                             axis=1) if len(boxes) else np.zeros((0, 5), np.float32)
        target, max_size = self.cfg.SCALES[0]
        u8 = bool(self.cfg.TPU.get("H2D_UINT8", True))
        img, im_info, gt_scaled = prepare_image(
            im, target, max_size,
            None if u8 else self.cfg.network.PIXEL_MEANS, self.buckets,
            flip=flip, boxes=gt5)
        if bool(self.cfg.TPU.get("S2D_INPUT", True)):
            # the planar relayout in the worker thread
            img = to_s2d_planar(img)
        gt = np.zeros((self.max_gt, 5), np.float32)
        gv = np.zeros((self.max_gt,), bool)
        n = min(len(gt_scaled), self.max_gt) if gt_scaled is not None else 0
        if n:
            gt[:n] = gt_scaled[:n]
            gv[:n] = True
        return img, im_info, gt, gv

    @staticmethod
    def _assemble(loaded):
        """Stack per-image worker outputs into one batch; images in a batch
        share the largest bucket among them (zero pad — consistent for both
        the HWC and the s2d planar layout, whose pad region is also zero)."""
        ims, infos, gts, gvs = zip(*loaded)
        planar = ims[0].ndim == 3 and ims[0].shape[0] == 12 \
            and ims[0].shape[-1] != 3
        if planar:                               # [12, H/2, W/2]
            bh = max(im.shape[1] for im in ims)
            bw = max(im.shape[2] for im in ims)
            out = np.zeros((len(ims), 12, bh, bw), ims[0].dtype)
            for b, im in enumerate(ims):
                out[b, :, :im.shape[1], :im.shape[2]] = im
        else:                                    # [H, W, 3]
            bh = max(im.shape[0] for im in ims)
            bw = max(im.shape[1] for im in ims)
            out = np.zeros((len(ims), bh, bw, 3), ims[0].dtype)
            for b, im in enumerate(ims):
                out[b, :im.shape[0], :im.shape[1]] = im
        return {"image": out, "im_info": np.stack(infos),
                "gt_boxes": np.stack(gts), "gt_valid": np.stack(gvs)}

    def _make_batch(self, indices):
        return self._assemble([self._load_one(self.roidb[i]) for i in indices])

    def __iter__(self):
        order = self._shuffled_order()
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order) - self.batch_size + 1,
                                  self.batch_size)]
        if self.num_prefetch <= 0 or self.num_workers <= 0:
            for b in batches:
                yield self._make_batch(b)
            return
        # per-image futures in an in-order window (num_prefetch batches
        # deep): the decode parallelism does not depend on the batch size
        with ThreadPoolExecutor(self.num_workers) as pool:
            inflight: deque = deque()
            it = iter(batches)
            try:
                while True:
                    while len(inflight) < self.num_prefetch:
                        b = next(it, None)
                        if b is None:
                            break
                        inflight.append([pool.submit(self._load_one,
                                                     self.roidb[i]) for i in b])
                    if not inflight:
                        break
                    futs = inflight.popleft()
                    yield self._assemble([f.result() for f in futs])
            finally:
                for futs in inflight:
                    for f in futs:
                        f.cancel()


class TestLoader:
    """Yields (image_id, image, im_info) one image at a time
    (TEST.BATCH_IMAGES=1, reference core/loader.py:25-167).

    Decode/resize/mean-sub (and the s2d planar relayout when enabled) run in
    a ``num_workers``-thread pool with a bounded in-order window (the
    reference's PrefetchingIterV2 worker threads,
    lib/utils/PrefetchingIter.py:19-150). The decode and the resize release
    the GIL, so the workers overlap."""

    __test__ = False          # not a pytest class

    def __init__(self, roidb, cfg, num_prefetch: int = 8, num_workers: int = 4,
                 image_loader=load_image_bgr):
        self.roidb = list(roidb)
        self.cfg = cfg
        self.buckets = [tuple(b) for b in cfg.TPU.IMAGE_BUCKETS]
        self.num_prefetch = max(num_prefetch, num_workers)
        self.num_workers = num_workers
        self.image_loader = image_loader

    def __len__(self):
        return len(self.roidb)

    def _load_one(self, entry):
        im = self.image_loader(entry["image"])
        target, max_size = self.cfg.SCALES[0]
        # H2D_UINT8: uint8 pixels after the resize, a quarter of the bytes
        # to copy; the exact mean subtraction and pad zeroing run on the
        # card (core/predictor.py::_image_from_u8; uint8 -> f32 is exact,
        # so the detections equal those of the host-f32 path)
        u8 = bool(self.cfg.TPU.get("H2D_UINT8", True))
        img, im_info, _ = prepare_image(
            im, target, max_size,
            None if u8 else self.cfg.network.PIXEL_MEANS, self.buckets)
        if bool(self.cfg.TPU.get("S2D_INPUT", True)):
            # the planar relayout in the worker thread
            img = to_s2d_planar(img)
        return entry.get("image_id", entry["image"]), img, im_info

    def __iter__(self):
        if self.num_prefetch <= 0 or self.num_workers <= 0:
            for e in self.roidb:
                yield self._load_one(e)
            return
        with ThreadPoolExecutor(self.num_workers) as pool:
            inflight: deque = deque()
            it = iter(self.roidb)
            try:
                while True:
                    while len(inflight) < self.num_prefetch:
                        e = next(it, None)
                        if e is None:
                            break
                        inflight.append(pool.submit(self._load_one, e))
                    if not inflight:
                        break
                    yield inflight.popleft().result()   # re-raises worker errors
            finally:
                for f in inflight:
                    f.cancel()


class ProposalTestLoader(TestLoader):
    """TestLoader + cached proposals (the reference's has_rpn=False TestLoader,
    core/loader.py:25-167 with proposal roidb from function/test_rcnn.py:40-51).

    Yields (image_id, image, im_info, rois [R, 4] scaled-image coords,
    rois_valid [R]) with R static (TEST.TOP_ROIS cap, score order preserved —
    generate_rpn_proposals writes score-descending boxes).
    """

    def __init__(self, roidb, cfg, proposal_file: str, **kw):
        super().__init__(roidb, cfg, **kw)
        import pickle
        with open(proposal_file, "rb") as f:
            props = pickle.load(f)
        assert len(props) == len(self.roidb), \
            f"{len(props)} proposal sets != {len(self.roidb)} images"
        top = int(cfg.TEST.get("TOP_ROIS", -1))
        if top > 0:
            props = [p[:top] for p in props]
        self.proposals = props
        self.max_rois = max(max((len(p) for p in props), default=1), 8)
        self._prop_by_idx = {id(e): p for e, p in zip(self.roidb, props)}

    def _load_one(self, entry):
        image_id, img, im_info = super()._load_one(entry)
        p = self._prop_by_idx[id(entry)]
        R = self.max_rois
        rois = np.zeros((R, 4), np.float32)
        valid = np.zeros((R,), bool)
        n = min(len(p), R)
        if n:
            rois[:n] = p[:n, :4] * float(im_info[2])   # original -> scaled coords
            valid[:n] = True
        return image_id, img, im_info, rois, valid
