"""Build and load the hand-written CUDA kernels of relation_tpu_torch/csrc/.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled on first
use by ``nvcc -gencode arch=compute_90a,code=sm_90a`` into its own shared
library, loaded with ctypes. Libraries go to ``relation_tpu_torch/_build/``
(listed in .gitignore), named by a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is reused. ``build_all`` starts
one nvcc per source at once and waits for all of them.

Nothing here runs at import time: this module imports on a machine with no
CUDA toolkit, where only the plain PyTorch versions of the kernels run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from relation_tpu_torch.utils import trace

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("geom_bias", "geom_bias_bwd", "nms_kernel", "stem", "nms_attention",
           "dconv_col2im", "bottleneck", "bias_attention", "roi_pool",
           "roi_align")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                       "relation_tpu_torch are built from source on first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for dep in sorted(CSRC.glob("*.cuh")):
        h.update(dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


@trace.span("setup.kernels")
def build_all(names=SOURCES) -> float:
    """Compile every missing library of ``names`` in parallel; returns the
    wall seconds spent. Raises with nvcc's output if any build fails. The
    ptxas report (registers, shared memory, spills) of each build is kept
    beside its library as ``<lib>.log``."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp,
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        trace.count("kernels.built")
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc/ptxas output of the library built for ``name`` ("" if reused)."""
    p = _lib_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        with trace.span("setup.kernels"):
            lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        trace.count("kernels.loaded")
    return lib


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def tally(shapes: dict, key: str) -> None:
    """Count one launch at ``key`` (a shape) in a kernel module's
    ``*_shapes`` dict, beside its plain launch counter."""
    shapes[key] = shapes.get(key, 0) + 1


def check(rc: int, name: str) -> None:
    """Raise if the C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def check_inputs(name: str, *tensors) -> None:
    """Same-device and contiguity checks shared by the wrappers."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input {tuple(t.shape)}")


def refuse_grad(name: str, *tensors) -> None:
    """A kernel with no backward refuses an input that asks for a gradient:
    it never answers with a result cut off from the graph."""
    import torch
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward and an input requires a "
            "gradient; call it under torch.no_grad() or on detached tensors")
