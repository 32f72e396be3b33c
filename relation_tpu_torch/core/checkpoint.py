"""Checkpoints (port of relation_tpu/core/checkpoint.py), in the JAX
package's own file format, so that each package reads the other's files.

Format: the msgpack of ``flax.serialization`` (``utils/msgpack.py`` writes
and reads it without flax). The parameter tree is the flax tree: the paths
of ``convert.py::to_jax_params`` unflattened on '/', conv kernels HWIO,
dense kernels [in, out]. A checkpoint holds

  step       int32, the train steps taken;
  params     the parameter tree;
  opt_state  the state dict of the JAX optimizer chain
             (relation_tpu/core/trainer.py::make_optimizer): {'0': {},
             '1': {'inner_state': {}}, '2': {'0': {'trace': <params tree>},
             '1': {'count': int32}}, '3': {'inner_state': {}},
             '4': {'inner_state': {}}}; the port's momentum buffers are the
             trace, zeros for frozen leaves (the JAX trace of a frozen leaf
             stays zero: stop_gradient and the masked weight decay give it
             nothing), and its schedule count is the count;
  rng        uint32 [2], the JAX key ``PRNGKey(seed)`` of the state's seed;
  torch_generator
             uint8, the state of the port's ``torch.Generator``. The JAX
             package reads the first four keys only and ignores this one.

A params file (``save_params``) is the bare tree, with an optional
``__meta__`` map of strings. Reading either kind takes the parameters
(``params_from_blob`` tells them apart by their keys).
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from relation_tpu_torch.convert import from_jax_params, to_jax_params
from relation_tpu_torch.utils import msgpack

_STATE_KEYS = {"step", "params", "opt_state", "rng"}


def _tree(flat: dict) -> dict:
    """{'a/b/leaf': array} -> nested dict."""
    out: dict = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _flat(tree, prefix: str = "") -> dict:
    """Nested dict -> {'a/b/leaf': leaf}."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, path + "/"))
        else:
            out[path] = v
    return out


def _state_dict(model_or_sd) -> dict:
    if isinstance(model_or_sd, torch.nn.Module):
        return model_or_sd.state_dict()
    return model_or_sd


def params_tree(model_or_sd) -> dict:
    """The flax parameter tree (float32 numpy leaves) of a model or of a
    state_dict."""
    return _tree(to_jax_params(_state_dict(model_or_sd)))


def _write(path: str, payload) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack.packb(payload))
    os.replace(tmp, path)
    return path


def _read(path: str):
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read())


def _key_of(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed) of the default threefry keys: [hi, lo]."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.asarray([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def save_checkpoint(path: str, state) -> str:
    """Write a TrainState (core/trainer.py): the model's parameters, the
    momentum buffers, the step, the schedule's count, the generator."""
    sd = state.model.state_dict()
    trace = {k: (state.trace[k] if k in state.trace else torch.zeros_like(v))
             for k, v in sd.items()}
    payload = {
        "step": np.asarray(state.step, np.int32),
        "params": params_tree(sd),
        "opt_state": {
            "0": {}, "1": {"inner_state": {}},
            "2": {"0": {"trace": params_tree(trace)},
                  "1": {"count": np.asarray(state.count, np.int32)}},
            "3": {"inner_state": {}}, "4": {"inner_state": {}}},
        "rng": _key_of(state.seed),
        "torch_generator": state.generator.get_state().numpy(),
    }
    return _write(path, payload)


def restore_checkpoint(path: str, state):
    """Read a checkpoint of either package into ``state`` in place (its
    model's parameters, momentum buffers, step, count and generator) and
    return it. Every parameter of the file must match the model.

    A file the JAX package wrote carries no generator state, and a JAX key
    cannot give one: the generator is then reseeded with the seed of the
    file's key (``(key[0] << 32) | key[1]``, the seed of ``PRNGKey(seed)``),
    so the random draws after the restore are those of a fresh state with
    that seed, not a continuation. A saved generator state that ``state``'s
    generator refuses (one of another device type, or damaged bytes) is
    reseeded alike, with a warning that the draws do not continue."""
    payload = _read(path)
    model = state.model
    sd = from_jax_params(_flat(payload["params"]), model)
    model.load_state_dict(sd)
    trace = from_jax_params(_flat(payload["opt_state"]["2"]["0"]["trace"]), model)
    for k, buf in state.trace.items():
        buf.copy_(trace[k])
    state.step = int(payload["step"])
    state.count = int(payload["opt_state"]["2"]["1"]["count"])
    key = np.asarray(payload["rng"], np.uint64)
    state.seed = int((int(key[0]) << 32) | int(key[1]))
    gen_state = payload.get("torch_generator")
    if gen_state is None:
        state.generator.manual_seed(state.seed)
        return state
    try:
        state.generator.set_state(torch.from_numpy(np.array(gen_state,
                                                            np.uint8)))
    except (ValueError, RuntimeError) as e:
        logging.getLogger(__name__).warning(
            "%s: the generator state does not restore on %s (%s); reseeded "
            "with %d, so the random draws after this restore are not a "
            "continuation of the saved run", path, state.generator.device,
            e, state.seed)
        state.generator.manual_seed(state.seed)
    return state


def save_params(path: str, model_or_sd, meta: dict | None = None) -> str:
    """Write a params-only file; ``meta`` (strings) rides along under the
    reserved ``__meta__`` key, which the readers strip."""
    payload = params_tree(model_or_sd)
    if meta:
        payload["__meta__"] = {str(k): str(v) for k, v in meta.items()}
    return _write(path, payload)


def read_params_blob(path: str) -> tuple[dict, dict]:
    """One read of a checkpoint or params file -> ``(blob, meta)``: the
    decoded tree with ``__meta__`` stripped, and that map ({} if absent)."""
    blob = _read(path)
    meta = {}
    if isinstance(blob, dict):
        meta = dict(blob.pop("__meta__", None) or {})
    return blob, meta


def params_from_blob(blob, model) -> dict:
    """The float32 state_dict for ``model`` of a ``read_params_blob`` tree,
    of either format: a params file, or a checkpoint (its ``{step, params,
    opt_state, rng}`` keys; the params subtree is taken). Raises on a
    missing, extra or misshapen leaf."""
    if isinstance(blob, dict) and _STATE_KEYS <= set(blob):
        blob = blob["params"]
    return from_jax_params(_flat(blob), model)


def read_checkpoint_meta(path: str) -> dict:
    """The ``__meta__`` map of a params file ({} if absent)."""
    return read_params_blob(path)[1]


def load_params(path: str, model) -> dict:
    """``read_params_blob`` then ``params_from_blob``: the state_dict to
    load into ``model``."""
    return params_from_blob(read_params_blob(path)[0], model)


def check_parameter_shapes(loaded, template) -> None:
    """Raise ValueError on a leaf of ``template`` missing from ``loaded``,
    a leaf of ``loaded`` the template lacks, or a shape that differs (both
    state_dicts or models; reference Symbol.check_parameter_shapes)."""
    got, want = _state_dict(loaded), _state_dict(template)
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing:
        raise ValueError(f"missing params: {missing}")
    if extra:
        raise ValueError(f"unexpected params: {extra}")
    for k, v in want.items():
        if tuple(got[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch for {k}: loaded "
                             f"{tuple(got[k].shape)} vs expected {tuple(v.shape)}")


def fold_bbox_normalization(state_dict: dict, means, stds) -> dict:
    """BBOX_MEANS/STDS baked into the bbox_pred layer (reference
    core/callback.py:54-61): a new state_dict whose ``bbox_pred.weight``
    [4K, in] has its rows scaled by the stds (tiled over the K classes) and
    whose bias is b * stds + means. Predict with the folded weights and
    TRAIN.BBOX_NORMALIZATION_PRECOMPUTED off."""
    out = dict(state_dict)
    w, b = state_dict["bbox_pred.weight"], state_dict["bbox_pred.bias"]
    reps = b.shape[0] // 4
    stds_t = torch.as_tensor(np.tile(np.asarray(stds, np.float32), reps),
                             dtype=w.dtype, device=w.device)
    means_t = torch.as_tensor(np.tile(np.asarray(means, np.float32), reps),
                              dtype=w.dtype, device=w.device)
    out["bbox_pred.weight"] = w * stds_t[:, None]
    out["bbox_pred.bias"] = b * stds_t + means_t
    return out


# --------------------------------------------------------------------------
# the reference's (MXNet .params) names
# --------------------------------------------------------------------------

# first dense layers after a 7x7 ROI pool: MXNet flattens it (c, h, w), the
# port (h, w, c)
_CHW_DENSE = ("fc_new_1", "roi_pool_fc1")
POOLED_HW = 7


def reference_name_map(model_or_sd) -> dict[str, tuple[str, str]]:
    """MXNet arg/aux name -> (state_dict key, transform tag), the port's
    counterpart of the JAX package's map. The tag says how the MXNet array
    becomes the port's tensor (``reference_transform``):
      'conv'       [out, in, kh, kw]: the torch layout already;
      'dense'      [out, in]: the torch layout already;
      'dense_chw'  the first dense layer after the ROI pool: the input dim
                   permuted from MXNet's (c, h, w) to the port's (h, w, c);
      'grouped'    linear_out_*: MXNet's grouped 1x1 conv [G*E, F, 1, 1] ->
                   the port's [G, F, E];
      'raw'        biases and the BatchNorm vectors, as they are.
    The tag comes from the tensor (rank and name), so the FPN neck's and
    the tiny trunks' convs and the deformable res5's bare weight are 'conv'
    (the JAX map tags them by module name prefix)."""
    out = {}
    for key, v in _state_dict(model_or_sd).items():
        parts = key.split(".")
        leaf, mod = parts[-1], parts[-2] if len(parts) > 1 else ""
        if leaf == "weight":
            tag = ("conv" if v.dim() == 4 else
                   "dense_chw" if mod in _CHW_DENSE else "dense")
            out[f"{mod}_weight"] = (key, tag)
        elif leaf == "bias" or leaf in ("gamma", "beta", "moving_mean",
                                        "moving_var"):
            out[f"{mod}_{leaf}"] = (key, "raw")
        elif leaf.endswith("_weight"):
            out[leaf] = (key, "conv" if v.dim() == 4 else "grouped")
        elif leaf.endswith("_bias"):
            out[leaf] = (key, "raw")
    return out


def reference_transform(tag: str, w: np.ndarray, shape) -> np.ndarray:
    """An MXNet array -> the port's tensor layout of ``shape`` (float32)."""
    w = np.asarray(w)
    if tag == "dense_chw":
        o = w.shape[0]
        c = w.shape[1] // (POOLED_HW * POOLED_HW)
        w = (w.reshape(o, c, POOLED_HW, POOLED_HW).transpose(0, 2, 3, 1)
             .reshape(o, -1))
    elif tag == "grouped":
        g, f, e = shape
        w = w.reshape(g, e, f).transpose(0, 2, 1)
    out = np.ascontiguousarray(w, np.float32)
    if tuple(out.shape) != tuple(shape):
        raise ValueError(f"{tag}: converted shape {out.shape} != {tuple(shape)}")
    return out
