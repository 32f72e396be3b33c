"""Seeded random weights, made on the device in a few large draws.

Every leaf of the ``param_specs`` list of the configuration's reference
gets a value from one normal draw of a ``torch.Generator`` seeded with the
run's seed: trunk
convolution kernels He-normal (std sqrt(2/fan in)), the neck's and the
RPN's lecun-normal (std 1/sqrt(fan in)), dense kernels std 0.01, biases
zero (the learned-NMS logit's -3). BatchNorm holds the scale a trained
trunk has: the stem's scale 1/64 takes the pixels (std about 60) to unit
size, each residual branch's last scale 0.2 keeps the stream from growing
block after block, every other BatchNorm is the identity. So activations
stay of order one, as in a trained network, and SGD at the YAML's rate
does not diverge in the first steps. The layers named in the
configuration's ``init.head_scale`` are then scaled by its stored factors:
the four prediction layers' bring their outputs to a trained detector's
spread (RPN and class logits std 2, box deltas std 0.2), without which
every proposal is clipped to the whole image, and
``benchmark/tools/calibrate.py`` measures them; a configuration can scale
any other ``<layer>.weight`` there.
The program and the reference are handed the same tensors.
"""

from __future__ import annotations

import math

import torch

BN_ONES = ("gamma", "moving_var")


def make_weights(ref, config: dict, seed: int, device) -> dict:
    """{name: f32 tensor on ``device``} for ``config``'s detector, whose
    leaves its reference module ``ref`` lists."""
    specs = ref.param_specs(config["arch"])
    drawn = [(n, s) for n, s in specs
             if n.endswith(".weight") or n.endswith("_weight")]
    total = sum(math.prod(s) for _, s in drawn)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    buf = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, lo = {}, 0
    for name, shape in drawn:
        n = math.prod(shape)
        fan_in = math.prod(shape[1:])
        trunk = name.split(".")[0] in ("c4", "c5", "conv_new_1")
        std = (math.sqrt((2.0 if trunk else 1.0) / fan_in)
               if len(shape) == 4 else 0.01)
        out[name] = buf[lo:lo + n].view(shape).mul_(std)
        lo += n
    for name, shape in specs:
        if name in out:
            continue
        leaf = name.rsplit(".", 1)[-1]
        fill = (1.0 / 64 if name == "c4.bn_conv1.gamma" else
                0.2 if leaf == "gamma" and "_branch2c." in name else
                1.0 if leaf in BN_ONES else
                -3.0 if name == "learn_nms_head.nms_logit.bias" else 0.0)
        out[name] = torch.full(shape, fill, dtype=torch.float32, device=device)
    for layer, factor in config["init"]["head_scale"].items():
        out[f"{layer}.weight"].mul_(float(factor))
    return out
