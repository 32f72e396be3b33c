"""Scaling of random weights into a trained detector's operating range.

``convert.py::init_params`` gives a network whose trunk activations reach
several hundred. From there the RPN logits reach +-500 (tied foreground
probabilities of 1.0) and its box deltas 400 (every proposal clipped to
the whole image), so a band on the detections would compare degenerate
boxes, and a DCN model's offset branches start at zero. The two functions
here, run once on one request, move such a model to where a comparison
means something:

- ``calibrate_heads``: the four prediction layers (CALIBRATED) scaled so
  that their outputs have the spread of a trained detector; returns the
  factors, which ``apply_factors`` repeats on a fresh copy of the weights
  in one numpy product a layer (the production-shape gate,
  tools/flagship_golden.py, stores them);
- ``seed_offsets``: a DCN model's offset branches given small seeded
  non-zero weights.
"""

from __future__ import annotations

import numpy as np

# the prediction layers calibrated, in the order a request runs them, with
# the standard deviation each output is scaled to
CALIBRATED = (("rpn.rpn_cls_score", 2.0), ("rpn.rpn_bbox_pred", 0.2),
              ("cls_score", 2.0), ("bbox_pred", 0.2))


def calibrate_heads(model, predict, image, im_info) -> np.ndarray:
    """Scale the weights of the CALIBRATED layers in place so that, on one
    request ``predict(image, im_info)``, their outputs (bias removed) have
    the spread CALIBRATED gives them: RPN and class logits 2, box deltas
    0.2, each layer in the order the model runs it, the later ones seeing
    the calibrated earlier ones. An FPN's RPN head, which runs on five
    levels a request, is scaled on the first (P6). Returns the factors, f32
    [4] in CALIBRATED's order."""
    import torch
    mods = {model.get_submodule(name): (i, spread)
            for i, (name, spread) in enumerate(CALIBRATED)}
    factors = np.zeros(len(CALIBRATED), np.float32)
    hooks, done = [], set()

    def calibrate(m, _inp, out):
        if m in done:
            return None
        done.add(m)
        i, spread = mods[m]
        bias = m.bias.view((1, -1) + (1,) * (out.dim() - 2)).to(out.dtype)
        scale = spread / max(float((out - bias).float().std()), 1e-12)
        factors[i] = scale
        # detach() shares the version counter, so the bf16 copy that
        # Conv2d keeps of its weight is made again
        m.weight.detach().mul_(scale)
        return (out - bias) * scale + bias
    for m in mods:
        hooks.append(m.register_forward_hook(calibrate))
    try:
        with torch.no_grad():
            predict(image, im_info)
    finally:
        for h in hooks:
            h.remove()
    return factors


def scaled_weights(state_dict: dict, factors) -> dict:
    """{name.weight: f32 numpy} of the CALIBRATED layers, each multiplied
    by its factor on the host: the one expression the gate's golden and its
    check share."""
    return {f"{name}.weight":
            state_dict[f"{name}.weight"].detach().float().cpu().numpy()
            * np.float32(f)
            for (name, _), f in zip(CALIBRATED, np.asarray(factors, np.float32))}


def apply_factors(model, factors):
    """The model with its CALIBRATED layers' weights scaled (in place) by
    ``factors``, from calibrate_heads on the same initial weights."""
    import torch
    sd = model.state_dict()
    with torch.no_grad():
        for key, w in scaled_weights(sd, factors).items():
            sd[key].copy_(torch.from_numpy(w))
    return model


def seed_offsets(model, cfg, image, im_info, seed: int = 5) -> None:
    """Give a DCN model's offset branches small non-zero values. The JAX
    package and init_params start them at zero, which samples on the integer
    grid only and leaves the offset gradient trivial inputs. Every offset
    conv and the ``offset`` FC gets seeded random weights (the biases stay
    at zero: at x0.01 learning rate a bias of visible size would not move
    by one f32 step in a few updates), and one request scales each, in the
    order the model runs them, so that its output has standard deviation 1:
    about a pixel of offset in res5, and a bin shift of a tenth of the
    ROI's size (trans_std 0.1) in the head."""
    import torch
    from relation_tpu_torch.core.predictor import make_predict_fn
    mods = [m for name, m in model.named_modules()
            if name.endswith("_branch2b_offset") or name == "offset"]
    rng = np.random.RandomState(seed)
    hooks = []

    def calibrate(m, _inp, out):
        bias = m.bias.view((1, -1) + (1,) * (out.dim() - 2)).to(out.dtype)
        scale = 1.0 / max(float((out - bias).std()), 1e-12)
        m.weight.data.mul_(scale)
        return (out - bias) * scale + bias
    with torch.no_grad():
        for m in mods:
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.tensor(rng.randn(*m.weight.shape) / fan_in ** 0.5,
                                        dtype=torch.float32))
            hooks.append(m.register_forward_hook(calibrate))
    try:
        make_predict_fn(model, cfg)(image, im_info)
    finally:
        for h in hooks:
            h.remove()
