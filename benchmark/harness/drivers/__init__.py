"""The drivers, one file a mix kind: ``benchmark/run.py`` runs a mix of
kind ``<kind>`` with ``drivers/<kind>.py``, found by file (harness/
cells.py::driver, which refuses a driver that lacks a name of its KIND's
interface below).

Every driver has:

- ``KIND``: ``"train"`` or ``"serve"``, the suffix of the per-layer
  metrics its cells report, and the interface it has besides;
- ``run(ctx, t_start)``: builds the program and the traffic, warms every
  shape, measures for ``ctx["seconds"]``, checks what the timed path
  produced against ``ctx["reference"]`` (the configuration's reference
  module, benchmark/reference/__init__.py) and returns the run's summary:
  ``kind`` (its KIND), ``setup_s``, ``images``, ``window_s``, ``peak``,
  ``peak_window``, ``attempted``, ``failed``, ``checks`` {name: (value,
  limit)}. Where ``ctx["trace"]`` holds it also returns ``trace`` (the
  first traced window reduced, harness/trace.py, with ``images`` and
  ``window_s``), ``trace["stages"]`` and ``program`` (the stage window and
  the registry's snapshot of it, harness/stages.py::window),
  ``program_setup`` (the registry's snapshot of the set-up, common.py::
  setup_snapshot), ``flops_per_image`` and ``attn_least_s``;
- ``work_counts(ref, config, mix)``: (operations, least attention
  seconds) of one image of the cell, from the reference's counts.

A ``"train"`` driver also has ``build(ctx)``, which returns (model,
train state, step, weights, batches) as its window starts from: the
weights as the reference's ``param_specs`` names them and the batches as
its ``train_steps`` takes them (tools/control.py runs the reference on
both). A ``"serve"`` driver also has ``summarise(got, limits)``, which
turns the ``compare.dets_gap`` of each judged request into the checks
{name: (value, limit)}.
"""

INTERFACE = {"train": ("run", "work_counts", "build"),
             "serve": ("run", "work_counts", "summarise")}
