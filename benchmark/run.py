"""One run of one benchmark cell of relation_tpu_torch on one GPU.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell, its configuration and that
configuration's plain reference, its traffic mix, the mix kind's driver
and its metrics are found by name from BENCHMARK.json
(benchmark/harness/cells.py). The run makes its weights and inputs from the
seed, warms every shape, measures for ``--seconds``, then checks what the
timed path produced against the reference (benchmark/reference/), prints
the numbers compared with their limits as the last lines of standard
error, and prints one JSON line last on standard output. ``--trace 1``
reports the per-layer metrics instead of the end-to-end ones, and turns
the program's span-and-counter registry on for the set-up and for a traced
window of its own (benchmark/harness/stages.py).

``--rehearse`` runs the cell at a tiny size on the CPU with the kernels'
plain versions (the tests' mode; its numbers are no device numbers), and
``--fault`` plants one of the faults the check must catch (the tests').
``--mix key=value`` changes one parameter of the mix (a sweep's).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FAULTS = ("frozen_state", "half_batch", "altered_answer")


def _environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout; no JAX
    pulled in by a library."""
    cache = ROOT / "benchmark" / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def _power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def main(argv=None, keep=None) -> int:
    """One run; the driver's summary is appended to the list ``keep``
    where one is given (the tools')."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--fault", choices=FAULTS, default="", help=argparse.SUPPRESS)
    ap.add_argument("--mix", nargs="*", default=[], help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    _environment()
    from benchmark.harness import cells
    from benchmark.harness.common import (emit, forbidden_modules, rehearsal,
                                          set_precision)
    spec = cells.resolve(args.workload, ROOT)
    import torch
    chips = int(spec["cell"]["chips"])
    if not args.rehearse and (not torch.cuda.is_available()
                              or torch.cuda.device_count() < chips):
        print(f"run.py: {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    config, mix = spec["config"], spec["mix"]
    if args.rehearse:
        config, mix = rehearsal(config, mix)
    for item in args.mix:              # key=value: a sweep's change of the mix
        key, value = item.split("=", 1)
        mix = dict(mix, **{key: json.loads(value)})
    set_precision(config["precision"])
    device = torch.device("cpu" if args.rehearse else "cuda")
    ctx = {"config": config, "reference": spec["reference"], "mix": mix,
           "seed": args.seed, "device": device, "seconds": args.seconds,
           "trace": bool(args.trace), "rehearse": args.rehearse,
           "fault": args.fault}
    driver = cells.driver(mix["kind"], ROOT)
    out = driver.run(ctx, T_START)
    if keep is not None:
        keep.append(out)
    bad = forbidden_modules()
    if bad:
        print(f"run.py: JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    metrics = {}
    for m in (spec["per_layer"] if args.trace else spec["end_to_end"]):
        value = cells.metric_reader(m["name"], ROOT)(out)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "cpu" if args.rehearse else "gpu",
           "kind": "cpu rehearsal" if args.rehearse else torch.cuda.get_device_name(0),
           "count": 1 if args.rehearse else chips,
           "memory_peak_bytes": int(out["peak"])}
    if not args.rehearse:
        dev["power_limit"] = _power_limit()
    result = {"correct": False, "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": dev}
    if args.trace and "trace" in out:
        dev["busy_s"] = out["trace"]["busy_s"]
        dev["window_s"] = out["trace"]["window_s"]
        result["breakdown"] = out["trace"]["breakdown"]
    checks = out["checks"]
    result["correct"] = all(v == v and v <= lim for v, lim in checks.values())
    emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
