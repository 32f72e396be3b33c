"""Parameters across the two packages, and a deterministic initialiser.

``from_jax_params`` maps the flattened flax parameter tree of the JAX package
onto this package's ``state_dict``: the module trees mirror each other, so a
flax path ``a/b/leaf`` becomes the torch key ``a.b.leaf`` with

  - conv ``kernel`` HWIO -> ``weight`` OIHW, and the same for the bare
    rank-4 ``*_weight`` of a deformable conv (``res5x_branch2b_weight``,
    which keeps its name),
  - dense ``kernel`` [in, out] -> ``weight`` [out, in],
  - ``bias`` (the offset convs and the ``offset`` Dense of the DCN symbols
    have one), the grouped ``*_weight`` [g, f, e] / ``*_bias`` and the four
    FrozenBatchNorm vectors kept as they are.

``to_jax_params`` is the inverse, from a state_dict (or any dict of the same
keys, such as gradients) to flat flax paths, so that updated parameters can
be compared leaf by leaf.

The caller flattens the tree (``flax.traverse_util.flatten_dict(params,
sep="/")``), so this module needs no flax. ``init_params`` fills a model
from a seed with numpy, at the scales of the flax initialisers.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch


def _torch_key_and_value(path: str, value: np.ndarray):
    parts = path.split("/")
    leaf = parts[-1]
    if leaf == "kernel":
        value = (value.transpose(3, 2, 0, 1) if value.ndim == 4
                 else value.T if value.ndim == 2 else None)
        if value is None:
            raise ValueError(f"{path}: kernel of unexpected rank")
        leaf = "weight"
    elif leaf.endswith("_weight") and value.ndim == 4:
        value = value.transpose(3, 2, 0, 1)
    return ".".join(parts[:-1] + [leaf]), value


def from_jax_params(flat: dict, model: torch.nn.Module) -> dict:
    """flax '/'-joined path -> numpy array, to a state_dict of float32
    tensors for ``model``. Raises unless the keys are exactly the model's
    state_dict keys and every shape matches."""
    out = {}
    for path, value in flat.items():
        key, v = _torch_key_and_value(path, np.asarray(value))
        if key in out:
            raise ValueError(f"{path}: duplicate target key {key}")
        out[key] = torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
    want = model.state_dict()
    missing = sorted(set(want) - set(out))
    extra = sorted(set(out) - set(want))
    if missing or extra:
        raise KeyError(f"from_jax_params: missing {missing[:8]} "
                       f"({len(missing)}), extra {extra[:8]} ({len(extra)})")
    bad = [(k, tuple(out[k].shape), tuple(want[k].shape))
           for k in want if tuple(out[k].shape) != tuple(want[k].shape)]
    if bad:
        raise ValueError(f"from_jax_params: shape mismatch {bad[:8]}")
    return out


def to_jax_params(state_dict: dict) -> dict:
    """state_dict key -> tensor, to {flax '/'-joined path: float32 numpy
    array}: the inverse of ``from_jax_params``. A 4-D ``weight`` is a conv
    kernel (OIHW -> HWIO ``kernel``), a 2-D ``weight`` a dense kernel
    ([out, in] -> [in, out]), a 4-D ``*_weight`` the bare deformable-conv
    weight (OIHW -> HWIO, name kept); every other leaf keeps its name and
    layout."""
    out = {}
    for key, value in state_dict.items():
        v = value.detach().to(torch.float32).cpu().numpy()
        parts = key.split(".")
        if parts[-1] == "weight":
            if v.ndim == 4:
                v = v.transpose(2, 3, 1, 0)
            elif v.ndim == 2:
                v = v.T
            else:
                raise ValueError(f"{key}: weight of unexpected rank {v.ndim}")
            parts[-1] = "kernel"
        elif parts[-1].endswith("_weight") and v.ndim == 4:
            v = v.transpose(2, 3, 1, 0)
        # a copy: the result must not alias parameters that train in place
        out["/".join(parts)] = np.array(v, order="C")
    return out


def _truncated_normal(rng: np.random.RandomState, shape) -> np.ndarray:
    """Standard normal truncated to [-2, 2] (flax's truncated_normal)."""
    x = rng.standard_normal(shape)
    bad = np.abs(x) > 2
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(x) > 2
    return x


def init_params(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Fill ``model`` deterministically from ``seed`` (each tensor from a
    numpy RandomState seeded by the seed and a CRC of its key), at the flax
    initialisers' scales: lecun-normal for the trunk and RPN convs,
    normal(0.01) for the head, zero biases, nms_logit bias -3.0
    (relation_tpu/models/learn_nms.py:167-169), BatchNorm at identity. Of
    the DCN leaves, the offset convs and the ``offset`` FC start at zero as
    in the JAX package (so a fresh model samples on the integer grid), and
    the bare deformable weight takes variance_scaling(2.0, fan_out).
    Returns the model."""
    sd = {}
    for key, t in model.state_dict().items():
        shape = tuple(t.shape)
        leaf = key.rsplit(".", 1)[-1]
        rng = np.random.RandomState((zlib.crc32(key.encode()) ^ seed) & 0x7FFFFFFF)
        if leaf in ("gamma", "moving_var"):
            v = np.ones(shape)
        elif leaf in ("beta", "moving_mean") or leaf.endswith("bias"):
            v = np.full(shape, -3.0 if key.endswith("nms_logit.bias") else 0.0)
        elif key.endswith("_offset.weight") or key == "offset.weight":
            v = np.zeros(shape)
        elif len(shape) == 4 and leaf.endswith("_weight"):
            fan_out = shape[0] * shape[2] * shape[3]
            v = _truncated_normal(rng, shape) * (np.sqrt(2.0 / fan_out)
                                                 / 0.87962566103423978)
        elif len(shape) == 4 and key.split(".")[0] in ("c4", "c5", "rpn"):
            fan_in = int(np.prod(shape[1:]))
            v = _truncated_normal(rng, shape) * (np.sqrt(1.0 / fan_in)
                                                 / 0.87962566103423978)
        else:
            v = rng.standard_normal(shape) * 0.01
        sd[key] = torch.from_numpy(v.astype(np.float32))
    model.load_state_dict(sd, strict=True)
    return model
