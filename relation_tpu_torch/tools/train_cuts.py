"""Cumulative-cut profile of the train step, on one CUDA card (the port's
tools/microbench_train_cuts.py).

    python3 -m relation_tpu_torch.tools.train_cuts [--family flagship|dcn|fpn]
        [--mode fwd|bwd] [--no-grad] [--batch 2] [--cuts rpn head ...]
        [--legs full f_res3 ...] [--steps 10] [--rounds 3] [--profile]
        [--set SECTION.KEY=VAL ...]

Each leg builds the real train step truncated or frozen, so every
measurement is the production step, never an isolated probe:

- ``--mode fwd`` (default): one leg a ``stop_after`` cut of
  core/trainer.py::make_train_step (STOP_AFTER, then "" for the full step),
  in order; the delta between successive cuts is one stage's forward plus
  its backward (``--no-grad``: its forward alone).
- ``--mode bwd``: every leg is the full step, with more of the net frozen
  (``fixed_prefixes``) from the bottom up (BWD_LEGS; FPN_BWD_LEGS for the
  fpn family), so the delta between successive legs is one stage's whole
  backward; ``fwd_only`` is the forward-only step.

Families: ``flagship`` (family_cfg("flagship")), ``dcn`` (dcn_learn_nms,
offsets seeded away from zero by tools/calibrate.py::seed_offsets) and
``fpn``: the fpn_learn_nms YAML's RCNN step on cached proposals
(core/rpn_workflow.py::make_train_step_rcnn, max_rois 1000 = TRAIN.TOP_ROIS,
cuts STOP_AFTER_RCNN, then ""), its prediction layers calibrated by
tools/calibrate.py::calibrate_heads. The cfg edits of the JAX tool: lr
1e-5, no warm-up, TPU.GRAD_CLIP 1.0, then ``--set``. The batch is the JAX
tool's: seeded s2d images (RandomState(0), x40) at 608x1024 with three boxes
each (TPU.MAX_GT rows), and for fpn 1000 seeded ROIs an image.

The legs run in ``--rounds`` rounds, one after the other in each round, so
that a drift of the host clock spreads over every leg. In each round a leg
starts from the same weights, takes one warm-up step and then ``--steps``
steps, each timed by the host clock up to ``torch.cuda.synchronize()`` and
by CUDA events around the step (the host clock varies up to 1.8x between
runs of one tree, PERF.md section 5): the medians of both over all rounds,
then the per-stage deltas between successive legs. A step reads the host
mid-way (the learned-NMS branch, the proposal counts), so the events span
the host's waits too: the column is labelled ``events (host-synced)`` and
is no device time. ``--profile`` takes one torch.profiler trace over all
the legs (one session a process: the profiler fault of ROADMAP's facts),
each timed step in a ``record_function`` window of its own, and adds the
device's busy time a step (kernels, copies and sets inside the window,
overlaps merged; median) and its deltas. Under the profiler the host times
carry its cost; keep ``--steps`` and ``--rounds`` small there (each step
records some 10^4 events). Prints the card's name and power limit first.
``--device cpu --tiny`` runs the same legs on the tiny trunk on the CPU
(host clock only), a rehearsal of the tool.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import statistics
import subprocess
import time

import numpy as np

# the JAX tool's legs (tools/microbench_train_cuts.py): freeze prefixes added
# to network.FIXED_PARAMS, bottom up; None is the forward-only step
BWD_LEGS = [
    ("full", ()),
    ("f_res3", ("res3", "bn3")),
    ("f_res4", ("res3", "bn3", "res4", "bn4")),
    ("f_res5", ("res3", "bn3", "res4", "bn4", "res5", "bn5")),
    ("f_rpn", ("res3", "bn3", "res4", "bn4", "res5", "bn5", "rpn")),
    ("f_head", ("res3", "bn3", "res4", "bn4", "res5", "bn5", "rpn",
                "conv_new_1", "fc_new", "cls_score", "bbox_pred", "relation",
                "offset")),
    ("f_all", ("",)),          # '' prefix-matches every leaf
    ("fwd_only", None),
]
FPN_BWD_LEGS = [
    ("full", ()),
    ("f_res3", ("res3", "bn3")),
    ("f_res4", ("res3", "bn3", "res4", "bn4")),
    ("f_res5", ("res3", "bn3", "res4", "bn4", "res5", "bn5")),
    ("f_neck", ("res3", "bn3", "res4", "bn4", "res5", "bn5", "fpn_")),
    ("f_head", ("res3", "bn3", "res4", "bn4", "res5", "bn5", "fpn_",
                "roi_pool_fc", "cls_score", "bbox_pred", "relation")),
    ("f_all", ("",)),
    ("fwd_only", None),
]
FAMILY = {"flagship": "flagship", "dcn": "dcn_learn_nms", "fpn": "fpn_learn_nms"}
R_CACHED = 1000                    # TRAIN.TOP_ROIS of the FPN YAMLs


def parse_value(raw: str):
    """An override's value: a Python literal (1, 0.5, True, 'exact') or the
    raw string."""
    import ast
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def family_config(family: str, overrides=(), tiny: bool = False):
    """The config of a family with the JAX tool's edits and ``overrides``
    ("SECTION.KEY=VAL")."""
    from relation_tpu_torch.entry import family_cfg
    cfg = family_cfg(FAMILY[family], tiny_shapes=tiny)
    cfg.TRAIN.lr = 1e-5
    cfg.TRAIN.warmup = False
    cfg.TPU.GRAD_CLIP = 1.0
    for ov in overrides:
        path, _, raw = ov.partition("=")
        node = cfg
        *heads, leaf = path.split(".")
        for h in heads:
            node = node[h]
        node[leaf] = parse_value(raw)
        print(f"cfg override: {path} = {node[leaf]!r}", flush=True)
    return cfg


def make_batch(cfg, B: int, size=(608, 1024), fpn: bool = False) -> dict:
    """The JAX tool's batch: B seeded s2d images, three boxes each in
    TPU.MAX_GT rows, im_info [600, 1000, 1.667]; for ``fpn`` R_CACHED seeded
    cached ROIs an image."""
    H, W = size
    rng = np.random.RandomState(0)
    max_gt = int(cfg.TPU.get("MAX_GT", 100))
    sy, sx = H / 608, W / 1024
    gt = np.zeros((B, max_gt, 5), np.float32)
    gv = np.zeros((B, max_gt), bool)
    for b in range(B):
        gt[b, 0] = [30 * sx, 40 * sy, 260 * sx, 300 * sy, 17]
        gt[b, 1] = [300 * sx, 200 * sy, 580 * sx, 420 * sy, 3]
        gt[b, 2] = [100 * sx, 350 * sy, 220 * sx, 500 * sy, 56]
        gv[b, :3] = True
    batch = {"image": (rng.randn(B, 12, H // 2, W // 2) * 40).astype(np.float32),
             "im_info": np.tile(np.asarray([[600.0 * sy, 1000.0 * sx, 1.667]],
                                           np.float32), (B, 1)),
             "gt_boxes": gt, "gt_valid": gv}
    if fpn:
        R = R_CACHED if size == (608, 1024) else 40
        rois = np.zeros((B, R, 4), np.float32)
        for b in range(B):
            xy = rng.rand(R, 2) * [900 * sx, 500 * sy]
            wh = (20 + rng.rand(R, 2) * [400, 300]) * [sx, sy]
            rois[b, :, :2] = xy
            rois[b, :, 2:] = np.minimum(xy + wh, [999 * sx, 599 * sy])
        batch["rois"] = rois
        batch["rois_valid"] = np.ones((B, R), bool)
    return batch


def legs_of(args) -> list:
    """[(name, kwargs of the step factory)] in order."""
    fpn = args.family == "fpn"
    if args.mode == "bwd":
        table = FPN_BWD_LEGS if fpn else BWD_LEGS
        return [(name, {"no_grad": True} if extra is None else
                 {"extra": extra})
                for name, extra in table
                if args.legs is None or name in args.legs]
    from relation_tpu_torch.core.rpn_workflow import STOP_AFTER_RCNN
    from relation_tpu_torch.core.trainer import STOP_AFTER
    cuts = (STOP_AFTER_RCNN if fpn else STOP_AFTER) + ("",)
    if args.cuts is not None:
        unknown = [c for c in args.cuts if c not in cuts and c != "full"]
        if unknown:
            raise SystemExit(f"unknown cuts {unknown}: one of {cuts}")
        cuts = [c for c in cuts if (c or "full") in args.cuts]
    prefix = "ng_" if args.no_grad else ""
    return [(prefix + (c or "full"), {"stop_after": c, "no_grad": args.no_grad})
            for c in cuts]


def step_factory(model, cfg, args, device):
    """kwargs -> the train step of one leg."""
    from relation_tpu_torch.core.rpn_workflow import make_train_step_rcnn
    from relation_tpu_torch.core.trainer import make_train_step
    base = tuple(cfg.network.FIXED_PARAMS)

    def make(stop_after="", no_grad=False, extra=None):
        kw = {"stop_after": stop_after, "no_grad": no_grad, "device": device}
        if extra is not None:
            kw["fixed_prefixes"] = base + tuple(extra)
        if args.family == "fpn":
            return make_train_step_rcnn(model, cfg, max_rois=R_CACHED,
                                        max_gt=int(cfg.TPU.get("MAX_GT", 100)),
                                        **kw)
        return make_train_step(model, cfg, **kw)
    return make


def time_leg(torch, model, cfg, start, step, batch, steps: int, cuda: bool,
             mark=contextlib.nullcontext):
    """(host ms list, CUDA-event ms list, last metrics) of ``steps`` steps
    after one warm-up, each from the weights ``start`` (a fresh state), each
    inside ``mark()``."""
    from relation_tpu_torch.core.trainer import create_train_state
    model.load_state_dict(start)
    state = create_train_state(model, cfg, seed=0)
    step(state, batch)                                  # warm-up
    host, dev, m = [], [], None
    for _ in range(steps):
        if cuda:
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        with mark():
            if cuda:
                e0.record()
            t0 = time.perf_counter()
            _, m = step(state, batch)
            if cuda:
                e1.record()
                torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            dev.append(e0.elapsed_time(e1))
    return host, dev, {k: float(v) for k, v in m.items()}


MARK = "train_cuts:"


def busy_by_leg(torch, prof) -> dict:
    """{leg: [device busy ms of each step]} of a profile whose steps ran
    in record_function(MARK + leg) windows: the kernels, copies and sets
    inside each window, clipped to it, overlaps merged."""
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    windows = [(e.name[len(MARK):], e.time_range.start, e.time_range.end)
               for e in events
               if e.name.startswith(MARK) and e.device_type != cuda]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == cuda and not e.name.startswith(MARK))
    starts = [s0 for s0, _ in spans]
    longest = max((s1 - s0 for s0, s1 in spans), default=0.0)
    out = {}
    for name, w0, w1 in windows:
        busy, cur = 0.0, None
        for s0, s1 in spans[bisect.bisect_left(starts, w0 - longest):]:
            if s0 >= w1:
                break
            s0, s1 = max(s0, w0), min(s1, w1)
            if s1 <= s0:
                continue
            if cur is None or s0 > cur[1]:
                busy += 0.0 if cur is None else cur[1] - cur[0]
                cur = [s0, s1]
            else:
                cur[1] = max(cur[1], s1)
        busy += 0.0 if cur is None else cur[1] - cur[0]
        out.setdefault(name, []).append(busy / 1e3)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--family", choices=sorted(FAMILY), default="flagship")
    ap.add_argument("--mode", choices=["fwd", "bwd"], default="fwd")
    ap.add_argument("--no-grad", action="store_true",
                    help="fwd mode: every cut without the backward")
    ap.add_argument("--batch", type=int, nargs="+", default=[2])
    ap.add_argument("--cuts", nargs="+", default=None,
                    help="fwd mode: the cuts to run ('full' for the whole step)")
    ap.add_argument("--legs", nargs="+", default=None,
                    help="bwd mode: the legs to run")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--set", dest="overrides", nargs="+", default=[],
                    metavar="SECTION.KEY=VAL")
    ap.add_argument("--profile", action="store_true",
                    help="device busy time a step, from one profiler trace")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny trunk, tiny proposal counts, 64x128 images")
    args = ap.parse_args(argv)
    import torch
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.predictor import build_predict_fn
    from relation_tpu_torch.core.trainer import build_model, resolve_device
    from relation_tpu_torch.tools.calibrate import calibrate_heads, seed_offsets
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    card = "cpu"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader", "-i", "0"],
                              capture_output=True, text=True,
                              timeout=60).stdout.strip()
    print(card, flush=True)
    size = (64, 128) if args.tiny else (608, 1024)
    cfg = family_config(args.family, args.overrides, args.tiny)
    model = init_params(build_model(cfg, tiny=args.tiny, device=device), seed=0)
    probe = make_batch(cfg, 1, size, args.family == "fpn")
    image = torch.tensor(probe["image"][0], device=device)
    im_info = torch.tensor(probe["im_info"][0], device=device)
    if args.family == "dcn":
        seed_offsets(model, cfg, image, im_info)
    if args.family == "fpn":
        calibrate_heads(model, build_predict_fn(model, cfg), image, im_info)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    make = step_factory(model, cfg, args, device)
    legs = legs_of(args)
    results = {}
    for B in args.batch:
        batch = make_batch(cfg, B, size, args.family == "fpn")
        steps = {name: make(**kw) for name, kw in legs}
        times = {name: ([], []) for name, _ in legs}
        last = {}
        with contextlib.ExitStack() as stack:
            prof = (stack.enter_context(torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])) if args.profile else None)
            for _ in range(args.rounds):
                for name, _ in legs:
                    mark = ((lambda n=name: torch.profiler.record_function(MARK + n))
                            if prof is not None else contextlib.nullcontext)
                    host, dev, m = time_leg(torch, model, cfg, start, steps[name],
                                            batch, args.steps, cuda, mark)
                    bad = [k for k, v in m.items() if not np.isfinite(v)]
                    if bad:
                        raise SystemExit(f"B={B} {name}: non-finite metrics {bad}")
                    times[name][0].extend(host)
                    times[name][1].extend(dev)
                    last[name] = m
        busy = busy_by_leg(torch, prof) if prof is not None else {}
        nan = float("nan")
        for name, _ in legs:
            (host, dev), m = times[name], last[name]
            h = statistics.median(host)
            d = statistics.median(dev) if dev else nan
            u = statistics.median(busy[name]) if busy.get(name) else nan
            results[(B, name)] = (h, d, u)
            print(f"B={B} {args.family} {name:<16} host {h:9.3f} ms "
                  f"({h / B:8.3f} /img)  events (host-synced) {d:9.3f} ms"
                  + (f"  device busy {u:9.3f} ms" if prof is not None else "")
                  + f"  total_loss {m['total_loss']:.6g}", flush=True)
        print(f"\nper-stage deltas, B={B} ({args.mode}"
              f"{', no grad' if args.no_grad else ''}"
              f"{', under the profiler' if prof is not None else ''}; on {card}):",
              flush=True)
        prev = None
        for name, _ in legs:
            now = results[(B, name)]
            if prev is not None:
                # fwd: a later cut adds a stage; bwd: a later leg freezes one
                sign = 1 if args.mode == "fwd" else -1
                dh, dd, du = (sign * (x - y) for x, y in zip(now, prev[1]))
                what = (f"{prev[0]} -> {name}" if args.mode == "fwd"
                        else f"{name} saves")
                print(f"  {what:<32} host {dh:+9.3f} ms  events (host-synced) "
                      f"{dd:+9.3f} ms"
                      + (f"  device busy {du:+9.3f} ms" if prof is not None else ""),
                      flush=True)
            prev = (name, now)
    return results


if __name__ == "__main__":
    main()
