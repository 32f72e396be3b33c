"""The port's span-and-counter registry (relation_tpu_torch/utils/trace.py)
on the CPU with tiny flagship and FPN models: the stages of a request and of
a train step, nesting on the host clock and in a profiler trace, the
disabled path, the counters at the program's host reads, and the kernel
launch counters it reports."""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from relation_tpu_torch.utils import trace

PREDICT_STAGES = ("predict.input", "predict.trunk_rpn", "predict.proposals",
                  "predict.head", "predict.tail")
FAMILIES = ("flagship", "fpn_learn_nms")


@pytest.fixture
def registry():
    """The registry enabled and empty for one test, off again after it."""
    trace.reset()
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()
        trace.reset()


@pytest.fixture(scope="module")
def tiny():
    """family -> (cfg, model, predict, image, im_info): the tiny trunk at
    the family's tiny proposal counts, weights from init_params."""
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.predictor import build_predict_fn
    from relation_tpu_torch.core.trainer import build_model
    from relation_tpu_torch.entry import family_cfg
    done = {}

    def get(family):
        if family not in done:
            cfg = family_cfg(family, tiny_shapes=True)
            model = init_params(build_model(cfg, tiny=True, device="cpu"),
                                seed=0)
            image = torch.tensor((np.random.RandomState(1).randn(64, 64, 3)
                                  * 40).astype(np.float32))
            done[family] = (cfg, model, build_predict_fn(model, cfg), image,
                            torch.tensor([64.0, 64.0, 1.0]))
        return done[family]
    return get


def _batch(B=2, size=64, max_gt=4, seed=7):
    r = np.random.RandomState(seed)
    gt = np.zeros((B, max_gt, 5), np.float32)
    gv = np.zeros((B, max_gt), bool)
    for b in range(B):
        gt[b, 0] = [8, 10, 30, 34, 1 + b % 3]
        gt[b, 1] = [24, 28, 52, 58, 2]
        gv[b, :2] = True
    return {"image": (r.randn(B, size, size, 3) * 40).astype(np.float32),
            "im_info": np.tile([[size, size, 1.0]], (B, 1)).astype(np.float32),
            "gt_boxes": gt, "gt_valid": gv}


@pytest.mark.parametrize("family", FAMILIES)
def test_predict_counts_each_stage_once_inside_predict(tiny, registry, family):
    _, _, predict, image, im_info = tiny(family)
    registry.reset()
    predict(image, im_info)
    spans = registry.snapshot()["spans"]
    assert {k: v["count"] for k, v in spans.items()} == dict.fromkeys(
        ("predict",) + PREDICT_STAGES, 1)
    parent = spans["predict"]["total_s"]
    assert sum(spans[k]["total_s"] for k in PREDICT_STAGES) <= parent
    assert all(spans[k]["first_s"] == spans[k]["total_s"] == spans[k]["max_s"]
               for k in spans)


def test_predict_from_cached_rois_has_no_proposal_stage(tiny, registry):
    from relation_tpu_torch.core.predictor import make_predict_fn_rcnn
    cfg, model, _, image, im_info = tiny("fpn_learn_nms")
    rois = torch.tensor([[4.0, 4.0, 40.0, 30.0], [10.0, 12.0, 60.0, 60.0]] * 16)
    predict = make_predict_fn_rcnn(model, cfg)
    registry.reset()
    predict(image, im_info, rois, torch.ones(32))
    spans = registry.snapshot()["spans"]
    assert {k: v["count"] for k, v in spans.items()} == dict.fromkeys(
        ("predict",) + tuple(s for s in PREDICT_STAGES
                             if s != "predict.proposals"), 1)


def test_disabled_registry_records_nothing_and_opens_no_record(tiny,
                                                               monkeypatch):
    _, _, predict, image, im_info = tiny("flagship")
    trace.disable()
    trace.reset()

    def refuse(*a, **k):
        raise AssertionError("record_function called with the registry off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        predict(image, im_info)
    snap = trace.snapshot()
    assert snap["spans"] == {} and snap["counters"] == {}


@pytest.mark.parametrize("family", FAMILIES)
def test_detections_are_bit_equal_with_the_registry_on(tiny, family):
    _, _, predict, image, im_info = tiny(family)
    trace.disable()
    off = predict(image, im_info)["dets"]
    trace.enable()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            on = predict(image, im_info)["dets"]
    finally:
        trace.disable()
        trace.reset()
    assert torch.equal(off, on)


@pytest.mark.parametrize("family", FAMILIES)
def test_train_step_counts_backward_and_update_once_a_step(tiny, registry,
                                                           family):
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.trainer import (build_model,
                                                 create_train_state,
                                                 make_train_step)
    cfg = tiny(family)[0]
    model = init_params(build_model(cfg, tiny=True, device="cpu"), seed=0)
    state = create_train_state(model, cfg)
    step = make_train_step(model, cfg, device="cpu")
    registry.reset()
    for _ in range(2):
        state, _ = step(state, _batch())
    spans = registry.snapshot()["spans"]
    assert {k: v["count"] for k, v in spans.items()} == dict.fromkeys(
        ("step", "step.input", "step.trunk_rpn", "step.rois", "step.backward",
         "step.update"), 2)
    children = sum(v["total_s"] for k, v in spans.items() if k != "step")
    assert children <= spans["step"]["total_s"]


def test_profiler_trace_nests_the_stages_inside_predict(tiny, registry):
    _, _, predict, image, im_info = tiny("fpn_learn_nms")
    registry.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        predict(image, im_info)
        predict(image, im_info)
    ev = [e for e in prof.events() if e.name.startswith(trace.PREFIX)]
    outer = sorted((e.time_range.start, e.time_range.end) for e in ev
                   if e.name == "rn:predict")
    assert len(outer) == 2
    inner = [e for e in ev if e.name != "rn:predict"]
    assert sorted(e.name[3:] for e in inner) == sorted(PREDICT_STAGES * 2)
    for e in inner:
        assert any(s <= e.time_range.start and e.time_range.end <= t
                   for s, t in outer), e.name


def test_client_thread_spans_reach_a_trace_of_all_threads(tiny, registry):
    """The serving harness records every thread (profile_all_threads), a
    session under which torch's own C++ check reads False: the spans of a
    request served on a client thread are in the trace all the same."""
    _, _, predict, image, im_info = tiny("flagship")
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            experimental_config=config) as prof:
        client = threading.Thread(target=predict, args=(image, im_info))
        client.start()
        client.join(timeout=120)
    assert not client.is_alive()
    names = [e.name for e in prof.events() if e.name.startswith(trace.PREFIX)]
    assert sorted(names) == sorted(
        trace.PREFIX + n for n in ("predict",) + PREDICT_STAGES)


def test_counters_at_the_host_reads_and_the_branch(tiny, registry):
    """The FPN head reads its four level counts once a request, and the
    learned-NMS relation module counts the branch it took."""
    _, _, predict, image, im_info = tiny("fpn_learn_nms")
    registry.reset()
    predict(image, im_info)
    predict(image, im_info)
    counters = registry.snapshot()["counters"]
    assert counters["host_read.fpn_level_counts"] == 2
    branches = sum(v for k, v in counters.items()
                   if k.startswith("lnms.branch."))
    assert branches == 2
    assert set(k.split(".")[-1] for k in counters
               if k.startswith("lnms.branch.")) <= {"skip", "dense", "fused"}


def test_setup_spans_and_kernel_counters(registry):
    from relation_tpu_torch.core.trainer import build_model
    from relation_tpu_torch.entry import family_cfg
    from relation_tpu_torch.ops.kernels import _build
    _build.build_all(names=())
    build_model(family_cfg("flagship", tiny_shapes=True), tiny=True,
                device="cpu")
    spans = registry.snapshot()["spans"]
    assert spans["setup.kernels"]["count"] == 1
    assert spans["setup.model"]["count"] == 1
    assert "kernels.built" not in registry.snapshot()["counters"]


def _old_kernel_launches() -> dict:
    """parallel/launch.py::kernel_launches as it read before the registry
    took it over."""
    import importlib
    import pkgutil
    import relation_tpu_torch.ops.kernels as kernels
    out = {}
    for info in pkgutil.iter_modules(kernels.__path__):
        if info.name.startswith("_"):
            continue
        mod = importlib.import_module(f"{kernels.__name__}.{info.name}")
        for attr, v in vars(mod).items():
            if attr.endswith("launches") and isinstance(v, int):
                out[f"{info.name}.{attr}"] = v
            elif attr.endswith("launch_shapes") and isinstance(v, dict):
                out[f"{info.name}.{attr}"] = dict(v)
    return out


def test_snapshot_reports_the_launch_counters_as_before(monkeypatch):
    from relation_tpu_torch.ops.kernels import geom_bias, nms_kernel
    from relation_tpu_torch.parallel import launch
    monkeypatch.setattr(geom_bias, "launches", 3)
    monkeypatch.setattr(nms_kernel, "launch_shapes", {"C=1 Np=64": 2})
    want = _old_kernel_launches()
    assert want["geom_bias.launches"] == 3
    assert trace.snapshot()["launches"] == want
    assert launch.trace.kernel_launches() == want


def test_threads_lose_no_update(registry):
    """Client threads nest spans and count at once: every span and count
    arrives, each outer span holds its inner one."""
    import sys
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    n, k = 300, 8

    def client():
        for _ in range(n):
            with registry.span("outer", request=True):
                with registry.span("inner"):
                    registry.count("c")
                registry.count("c", 2)
    try:
        threads = [threading.Thread(target=client) for _ in range(k)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = registry.snapshot()
    assert snap["counters"] == {"c": 3 * n * k}
    assert snap["spans"]["outer"]["count"] == snap["spans"]["inner"]["count"] \
        == n * k
    spans = snap["spans"]
    assert spans["inner"]["total_s"] <= spans["outer"]["total_s"]


def test_span_decorates_and_reset_forgets(registry):
    @registry.span("f")
    def f(x):
        return x + 1
    assert f(1) == 2 and f.__name__ == "f"
    assert registry.snapshot()["spans"]["f"]["count"] == 1
    registry.reset()
    assert registry.snapshot()["spans"] == {}
    registry.disable()
    assert f(2) == 3 and registry.snapshot()["spans"] == {}
