"""Driver of mix kind "serve": closed-loop clients, each a host thread with
its own CUDA stream, all calling one predict function of the port
(core/predictor.py::build_predict_fn, as entry() builds it) on one shared
model. Each request sends a uint8 image from host memory and brings its
[max_det, 6] detections back to the host.

Set-up builds the model, loads the seeded weights, makes the pool of
distinct images and has every client serve its first requests. The window
counts the requests completed by all clients before it closes. The
harness's copy of the weights leaves the device once the model holds them,
so that the window's memory peak is the program's; the check makes them
again from the seed, and the configuration's reference serves the sampled
requests again with them.
"""

from __future__ import annotations

import contextlib
import gc
import random
import statistics
import sys
import threading
import time

import torch

from benchmark.harness import compare, flops, stages, trace, traffic
from benchmark.harness.common import (build_kernels, max_mem, program_cfg,
                                      program_registry, reset_mem,
                                      setup_snapshot, sync)
from benchmark.harness.weights import make_weights

KIND = "serve"             # the suffix of the per-layer metrics it reports


class Clients:
    """K closed-loop clients over a pool of host images; request i takes
    pool image order[i % n]."""

    def __init__(self, predict, images, infos, k, seed, cuda):
        self.predict, self.images, self.infos = predict, images, infos
        self.order = list(range(len(images)))
        random.Random(seed).shuffle(self.order)
        self.streams = [torch.cuda.Stream() if cuda else None for _ in range(k)]
        self.lock = threading.Lock()
        self.next = 0
        self.log = []              # (request, pool index, sent, done, dets)

    def _client(self, k, deadline, budget):
        stream = self.streams[k]
        with torch.cuda.stream(stream) if stream else contextlib.nullcontext():
            for _ in range(budget):
                if time.perf_counter() >= deadline:
                    return
                with self.lock:
                    i = self.next
                    self.next += 1
                j = self.order[i % len(self.order)]
                t = time.perf_counter()
                dets = self.predict(self.images[j], self.infos[j])["dets"].cpu()
                done = time.perf_counter()
                with self.lock:
                    self.log.append((i, j, t, done, dets))

    def serve(self, deadline, budget=1 << 62):
        """Every client serves until ``deadline`` (or ``budget`` requests
        each); returns the log entries of this call."""
        start = len(self.log)
        threads = [threading.Thread(target=self._client, args=(k, deadline, budget))
                   for k in range(len(self.streams))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return self.log[start:]


def run(ctx, t_start: float) -> dict:
    from relation_tpu_torch.core.predictor import build_predict_fn
    from relation_tpu_torch.core.trainer import build_model
    cj, mix, dev = ctx["config"], ctx["mix"], ctx["device"]
    cuda = dev.type == "cuda"
    registry = program_registry(ctx)
    cfg = program_cfg(cj, ctx["rehearse"])
    build_kernels(dev)
    W = make_weights(ctx["reference"], cj, ctx["seed"], dev)
    model = build_model(cfg, device=dev)
    model.load_state_dict(W, strict=True)
    del W
    predict = build_predict_fn(model, cfg)
    if ctx["fault"] == "altered_answer":
        whole = predict

        def predict(image, im_info):
            out = dict(whole(image, im_info))
            dets = out["dets"].clone()
            dets[0, 1] = dets[0, 1] * 1.5 + 0.01
            out["dets"] = dets
            return out
    imgs, infos = traffic.images(cj, int(mix["pool_images"]), ctx["seed"], dev)
    host_imgs = [im.cpu().pin_memory() if cuda else im.cpu() for im in imgs]
    host_infos = [r.cpu() for r in infos]
    del imgs
    clients = Clients(predict, host_imgs, host_infos, int(mix["clients"]),
                      ctx["seed"], cuda)
    clients.serve(float("inf"), int(mix["warm_requests"]))
    sync(ctx)
    setup_s = time.perf_counter() - t_start
    peak_setup = max_mem(ctx)
    program_setup = setup_snapshot(registry)
    reset_mem(ctx)
    t0 = time.perf_counter()
    log = clients.serve(t0 + ctx["seconds"])
    sync(ctx)
    close = t0 + ctx["seconds"]
    done = [r for r in log if r[3] <= close]
    lat = sorted(1e3 * (r[3] - r[2]) for r in done)
    out = {"kind": KIND, "setup_s": setup_s, "images": len(done),
           "window_s": ctx["seconds"], "peak_window": max_mem(ctx),
           "attempted": len(log), "failed": 0, "latency_ms": lat}
    out["peak"] = max(peak_setup, out["peak_window"])
    if ctx["trace"]:
        out["program_setup"] = program_setup
        spans = trace.install_spans(model)
        prof, twall, tlog = trace.profile(clients.serve,
                                          float(mix["trace_seconds"]), cuda)
        trace.remove_spans(spans)
        out["trace"] = dict(trace.reduce(prof), window_s=twall, images=len(tlog))
        del prof
        out["trace"]["stages"], out["program"] = stages.window(
            registry, clients.serve, float(mix["trace_seconds"]), cuda, len)
        out["flops_per_image"], out["attn_least_s"] = work_counts(
            ctx["reference"], cj, mix)
    del model, predict, clients.predict
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    # every request sent in the window is judged, one that finished after
    # its close too: late is not wrong
    sample = random.Random(ctx["seed"] + 1).sample(
        log, min(int(mix["check_requests"]), len(log)))
    out["checks"] = judge(ctx, sample, host_imgs, host_infos)
    return out


def work_counts(ref, config, mix):
    """(operations, least attention seconds) of one request over the
    configuration's ``rpn_post_nms_top_n`` proposals."""
    t = config["test"]
    R = int(t["rpn_post_nms_top_n"])
    return (ref.serve_flops(config),
            flops.attention_least_s(config, R, R, int(t["first_n"])))


def judge(ctx, sample, images, infos) -> dict:
    """The reference serves each sampled request again (summarise), with
    the weights made again from the seed."""
    limits = ctx["config"]["limits"]["serve"]
    dev, ref = ctx["device"], ctx["reference"]
    W = make_weights(ref, ctx["config"], ctx["seed"], dev)
    with torch.no_grad():
        got = [compare.dets_gap(dets, ref.predict(W, ctx["config"],
                                                  images[j].to(dev),
                                                  infos[j].to(dev)).cpu(),
                                int(limits["top"]))
               for _, j, _, _, dets in sample]
    return summarise(got, limits)


def summarise(got, limits) -> dict:
    """The numbers compared: the share of the sampled requests' first
    ``top`` detections that the reference does not reproduce (a same-class
    box within IoU 0.99), and the median over the requests of each one's
    score difference of the others, as a norm relative to their scores'
    norm. The median, because a near-tie that flips a proposal or a
    learned-NMS rank in one image moves every score of that image (the
    relation modules see all proposals); the norm over all requests, which
    such an image dominates, is printed beside it."""
    n = sum(g[0] for g in got)
    share = sum(g[1] for g in got) / max(n, 1)
    rels = sorted((g[3] / max(g[4], 1e-30)) ** 0.5 for g in got)
    med = statistics.median(rels) if rels else 0.0
    pooled = (sum(g[3] for g in got) / max(sum(g[4] for g in got), 1e-30)) ** 0.5
    print(f"serve check: {n} detections; score gap over all requests "
          f"{pooled!r}, the widest {max((g[2] for g in got), default=0.0)!r}, "
          f"per request largest {rels[-1] if rels else 0.0!r}", file=sys.stderr)
    return {"det_unmatched_share": (share, limits["det_unmatched_share"]),
            "det_score_rel_med": (med, limits["det_score_rel_med"])}
