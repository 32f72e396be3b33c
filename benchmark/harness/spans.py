"""Device time under spans of the program named in full, read from a traced
run's stage window (benchmark/harness/stages.py): the spans below a stage,
such as a deformable layer's ``dcn.conv`` inside ``step.trunk_rpn``, which
``stages.per_image`` (a step's or a request's own stages) does not name."""

from __future__ import annotations

from benchmark.harness.stages import _window


def dev_ms_per_image(out, names):
    """The device ms a traced image of the operations launched under the
    spans ``names`` (each the innermost open span at the launch), summed;
    None where the stage window has no device time or the program opened
    none of them."""
    st = _window(out)
    if st is None:
        return None
    rows = [st["stages"][n] for n in names if n in st["stages"]]
    if not rows:
        return None
    return sum(r["dev_ms"] for r in rows) / st["images"]
