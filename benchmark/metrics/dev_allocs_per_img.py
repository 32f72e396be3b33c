"""dev_allocs_per_img: the CUDA caching allocator's allocations from the device
(cudaMalloc calls, its num_device_alloc) in the traced window per image:
nonzero where the window's memory outgrows what the allocator holds."""

from benchmark.harness.stages import program


def read(out):
    snap = program(out)
    if snap is None or "allocator" not in snap:
        return None
    return snap["allocator"]["num_device_alloc"] / out["trace"]["images"]
