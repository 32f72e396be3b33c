"""Finding a cell's files by the names in BENCHMARK.json.

A cell ``<config>.<traffic>`` is one entry of ``workloads``. Its
configuration is the file its ``configs`` entry names; the configuration's
plain reference is ``benchmark/reference/<name>.py``, ``<name>`` the file's
``reference`` key (``detector`` where it has none); its traffic mix is
``benchmark/mixes/<traffic>.json``, run by the driver
``benchmark/harness/drivers/<kind>.py`` of the mix's ``kind``; each metric
it reports is read by ``benchmark/metrics/<base>.py``, ``<base>`` the
metric's name up to its first dot. Adding a configuration, a cell, a mix or
a metric is adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "benchmark"
DEFAULT_REFERENCE = "detector"
_loaded: dict = {}


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path}: no BENCHMARK.json at the checkout's root")
    return json.loads(path.read_text())


def _load(path: Path, what: str, tag: str):
    """The module of the Python file ``path``, executed once a process."""
    key = str(path.resolve())
    if key in _loaded:
        return _loaded[key]
    spec = importlib.util.spec_from_file_location(f"_bench_{tag}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"{path}: no {what}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _loaded[key] = mod
    return mod


def reference(config: dict, root: Path = ROOT):
    """The plain reference module of ``config``, with every name of the
    interface that benchmark/reference/__init__.py lists."""
    from benchmark.reference import INTERFACE
    name = config.get("reference", DEFAULT_REFERENCE)
    path = root / "benchmark" / "reference" / f"{name}.py"
    mod = _load(path, f"reference {name!r} of configuration "
                      f"{config.get('name')!r}", f"reference_{name}")
    missing = [n for n in INTERFACE if not callable(getattr(mod, n, None))]
    if missing:
        raise AttributeError(f"{path}: a reference lacks {missing}")
    return mod


def driver(kind: str, root: Path = ROOT):
    """The driver module of mix kind ``kind``, with every name of its
    KIND's interface (benchmark/harness/drivers/__init__.py)."""
    from benchmark.harness.drivers import INTERFACE
    path = root / "benchmark" / "harness" / "drivers" / f"{kind}.py"
    mod = _load(path, f"driver for mix kind {kind!r}", f"driver_{kind}")
    names = INTERFACE.get(getattr(mod, "KIND", None))
    if names is None:
        raise AttributeError(f"{path}: KIND is {getattr(mod, 'KIND', None)!r}, "
                             f"not one of {sorted(INTERFACE)}")
    missing = [n for n in names if not callable(getattr(mod, n, None))]
    if missing:
        raise AttributeError(f"{path}: a {mod.KIND!r} driver lacks {missing}")
    return mod


def resolve(name: str, root: Path = ROOT) -> dict:
    """Everything one run of cell ``name`` needs: its workload entry, its
    configuration and that configuration's reference, its mix, and the
    metrics it reports."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    mix_path = root / "benchmark" / "mixes" / f"{cell['traffic']}.json"
    mix = json.loads(mix_path.read_text())

    def applies(m):
        return name in m.get("workloads", [name])
    e2e = [m for m in bench["end_to_end"] if applies(m)]
    per_layer = [m for m in bench["per_layer"] if applies(m)]
    return {"cell": cell, "config": config, "reference": reference(config, root),
            "mix": mix, "end_to_end": e2e, "per_layer": per_layer,
            "run_seconds": int(bench["run_seconds"])}


def metric_reader(metric: str, root: Path = ROOT):
    """The ``read(summary)`` function of a per-layer metric's reader file."""
    base = metric.split(".", 1)[0]
    path = root / "benchmark" / "metrics" / f"{base}.py"
    spec = importlib.util.spec_from_file_location(f"_bench_metric_{base}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"{path}: no reader for metric {metric!r}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
