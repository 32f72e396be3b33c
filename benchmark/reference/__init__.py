"""The plain references, one file a model: a configuration file names its
own with ``"reference": "<name>"`` (``benchmark/reference/<name>.py``), and
``detector`` is the reference of every configuration that names none. The
harness loads it by file (harness/cells.py::reference) and calls it for the
weights, the checks, the operation counts and the calibration. Plain
PyTorch or NumPy: a reference imports nothing of the program under test
(``relation_tpu_torch``), nor ``jax`` or the JAX package, and takes from the
program nothing but the outputs it judges. A reference of a new model can
import the functions of another (``from benchmark.reference import
detector``) and needs no edit of any file already here.

A reference module provides:

- ``param_specs(arch) -> [(name, shape)]``: every leaf of the model the
  configuration's ``arch`` describes, named as the program's
  ``state_dict`` names it (the program loads the seeded weights with
  ``strict=True``; harness/weights.py draws them by this list);
- ``trainable(name, fixed) -> bool``: whether a leaf trains under the
  YAML's FIXED_PARAMS prefixes ``fixed``;
- ``predict(P, cfg, image_u8, im_info) -> [max_det, 6]``: one request's
  detections (class, score, x1, y1, x2, y2; class -1 pads) from the
  weights ``P`` (the serving check);
- ``train_steps(P0, cfg, batches, steps) -> (losses, first gradients,
  final weights)``: the first ``steps`` training steps from ``P0`` on
  the mix's batches (the training check);
- ``serve_flops(config) -> int``, ``train_flops(config, rois, gt) ->
  int``: the operations of one request and of one image of a training
  step (harness/flops.py's helpers count them on the ``meta`` device);
- ``calibration_outputs(P, cfg, image_u8, im_info)``: yields (layer,
  output) for each layer whose weight ``tools/calibrate.py`` scales, in
  the order a request runs them, each computed with the weights in ``P``
  when asked for.

harness/cells.py::reference refuses a module that lacks one of these
(INTERFACE). The comparisons that judge outputs against a reference's are
the harness's (harness/compare.py).
"""

INTERFACE = ("param_specs", "trainable", "predict", "train_steps",
             "serve_flops", "train_flops", "calibration_outputs")
