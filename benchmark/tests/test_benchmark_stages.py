"""The stage reduction (harness/stages.py) on a synthetic trace: device
time put down to the stage of its launch, on any thread; idle time split
over the stages it spans, summing to the window less the busy time; syncs
put down like launches; and the readers of the stage metrics."""

from __future__ import annotations

from types import SimpleNamespace

from benchmark.harness import cells, stages

CPU, CUDA = (stages.torch.autograd.DeviceType.CPU,
             stages.torch.autograd.DeviceType.CUDA)


def ev(name, start, end, thread=1, id=0, device=CPU):
    return SimpleNamespace(name=name, device_type=device, id=id,
                           thread=thread,
                           time_range=SimpleNamespace(start=start, end=end))


def request_trace():
    """Two requests on client thread 1 (the first with its five stages),
    four kernels, two of them overlapping and one launched from thread 2
    that opens no span, the device copy of a record, and three syncs, two
    inside ops."""
    return [
        ev("rn:predict", 0, 100), ev("rn:predict.input", 0, 10),
        ev("rn:predict.trunk_rpn", 10, 50), ev("rn:predict.head", 55, 80),
        ev("rn:predict.tail", 80, 98),
        ev("rn:predict", 120, 200), ev("rn:predict.input", 120, 130),
        ev("cudaLaunchKernel", 12, 13, id=101),
        ev("conv", 15, 40, id=101, device=CUDA),
        ev("cudaLaunchKernel", 20, 21, id=105),
        ev("conv_next", 30, 45, id=105, device=CUDA),
        ev("cudaLaunchKernel", 60, 61, id=102),
        ev("gemm", 62, 85, id=102, device=CUDA),
        ev("cudaLaunchKernel", 90, 90.5, thread=2, id=103),
        ev("add", 91, 95, id=103, device=CUDA),
        ev("rn:predict", 15, 95, id=104, device=CUDA),
        ev("aten::add", 2, 3, id=103),
        ev("aten::to", 4, 8), ev("aten::copy_", 4.5, 7),
        ev("aten::_local_scalar_dense", 100.5, 119.5),
        ev("cudaStreamSynchronize", 5, 6),
        ev("cudaStreamSynchronize", 88, 89, thread=2),
        ev("cudaMemcpy", 101, 119),
    ]


def test_device_idle_and_syncs_go_to_their_stages():
    st = stages.reduce(request_trace())
    assert st["window_ms"] == 0.2 and st["busy_ms"] == 0.057
    assert st["linked"] == 1.0
    got = {k: (round(1e3 * v["dev_ms"], 6), round(1e3 * v["idle_ms"], 6),
               v["syncs"], v["sync_sites"]) for k, v in st["stages"].items()}
    assert got == {"predict.input": (0, 20, 1, {"aten::copy_": 1}),
                   "predict.trunk_rpn": (30, 10, 0, {}),
                   "predict": (0, 77, 0, {}),
                   "predict.head": (23, 7, 0, {}),
                   "predict.tail": (4, 9, 1, {"-": 1}),
                   "outside": (0, 20, 1, {"aten::_local_scalar_dense": 1})}
    idle = sum(v["idle_ms"] for v in st["stages"].values())
    assert abs(idle - (st["window_ms"] - st["busy_ms"])) < 1e-12


def test_host_time_is_each_thread_s_innermost_stage():
    st = stages.reduce(request_trace())["stages"]
    host = {k: round(1e3 * v["host_ms"], 6) for k, v in st.items()}
    assert host == {"predict.input": 20, "predict.trunk_rpn": 40,
                    "predict": 77, "predict.head": 25, "predict.tail": 18,
                    "outside": 20}


def test_a_trace_without_program_spans_has_no_stages():
    events = [e for e in request_trace() if not e.name.startswith("rn:")]
    st = stages.reduce(events)
    assert st["stages"] == {} and st["busy_ms"] == 0.057
    out = {"kind": "serve", "trace": {"stages": st, "images": 2,
                                      "busy_s": 5.7e-5}}
    assert cells.metric_reader("idle_head_ms.serve")(out) is None


def test_readers_take_the_stages_of_the_cell_kind():
    st = stages.reduce(request_trace())
    out = {"kind": "serve", "trace": {"stages": st, "images": 2,
                                      "busy_s": 5.7e-5}}
    read = {m: cells.metric_reader(m)(out) for m in (
        "idle_input_ms.serve", "idle_outside_ms.serve",
        "proposals_dev_ms.serve", "idle_head_ms.serve")}
    assert {k: round(1e3 * v, 6) for k, v in read.items()} == {
        "idle_input_ms.serve": 10, "idle_outside_ms.serve": 10,
        "proposals_dev_ms.serve": 0, "idle_head_ms.serve": 3.5}
    out["kind"] = "train"
    assert cells.metric_reader("idle_input_ms.train")(out) == 0.0
    assert cells.metric_reader("idle_trunk_ms.train")(out) == 0.0


def test_registry_readers():
    snap = {"spans": {"setup.kernels": {"total_s": 1.5},
                      "setup.model": {"total_s": 0.25},
                      "predict": {"first_s": 4.0}},
            "counters": {"host_read.lnms_active": 6, "lnms.branch.skip": 6,
                         "host_read.fpn_level_counts": 2},
            "allocator": {"num_device_alloc": 3}}
    out = {"kind": "serve", "program": snap, "program_setup": snap,
           "trace": {"images": 2, "busy_s": 1.0}}
    read = {m: cells.metric_reader(m)(out) for m in (
        "host_reads_per_img.serve", "dev_allocs_per_img.serve",
        "setup_kernels_s.serve", "setup_model_s.serve", "first_call_s.serve")}
    assert read == {"host_reads_per_img.serve": 4.0,
                    "dev_allocs_per_img.serve": 1.5,
                    "setup_kernels_s.serve": 1.5, "setup_model_s.serve": 0.25,
                    "first_call_s.serve": 4.0}
    out["trace"]["busy_s"] = 0.0           # a CPU rehearsal's trace
    assert all(cells.metric_reader(m)(out) is None for m in read)
