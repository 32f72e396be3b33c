"""What the ablation tools (tools/ablate_*.py) share: variants of a kernel
source, each a few text substitutions away from it, built with one nvcc per
variant in parallel; CUDA-event timing; the card's name and power limit.
Needs a CUDA card and nvcc; nothing here runs at import time."""

from __future__ import annotations

import ctypes
import shutil
import statistics
import subprocess

import torch

from relation_tpu_torch.ops.kernels import _build

# variant -> [(file in csrc/, text, replacement)]
Variants = dict[str, list[tuple[str, str, str]]]


def print_card() -> None:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)


def build_variants(name: str, variants: Variants, csrc=None,
                   tag: str = "ablate") -> dict[str, ctypes.CDLL]:
    """{variant: library} of <csrc>/<name>.cu (csrc: this checkout's sources
    by default), each variant built from copies of the sources (the .cu and
    the headers beside it) into _build/<tag>_<name>/<variant>/ with its
    substitutions made. Raises if a text is not in its file, or if nvcc
    fails. Prints the ptxas register report of the unchanged variant
    ``full``."""
    root = _build.BUILD_DIR / f"{tag}_{name}"
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for var, subs in variants.items():
        files = {p.name: p.read_text()
                 for p in (csrc or _build.CSRC).glob("*.cu*")}
        for fname, a, b in subs:
            if a not in files[fname]:
                raise RuntimeError(f"{name} {var}: {a!r} is not in {fname}")
            files[fname] = files[fname].replace(a, b)
        d = root / var
        d.mkdir(parents=True)
        for fname, text in files.items():
            (d / fname).write_text(text)
        lib = d / f"lib{name}.so"
        procs[var] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(d / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for var, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} {var} failed:\n{log}")
        if var == "full":
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[ptxas] {name}: {line.strip()}", flush=True)
        libs[var] = ctypes.CDLL(str(lib))
    return libs


def time_ms(fn, inner: int = 10, reps: int = 11) -> float:
    """Median device ms per call (CUDA events around ``inner`` calls, after a
    sleep kernel that lets the host queue them all)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)
