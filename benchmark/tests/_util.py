"""Helpers of the benchmark's CPU tests: a rehearsal run of a cell."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def rehearse(workload: str, *extra: str, seed: int = 3000000017, trace: int = 0,
             seconds: float = 1.0):
    """run.py on the CPU at its tiny size: (exit code, result line or None,
    standard error)."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload, "--seed",
         str(seed), "--seconds", str(seconds), "--trace", str(trace),
         "--rehearse", *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=900, env=env)
    lines = p.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return p.returncode, result, p.stderr
