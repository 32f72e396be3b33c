"""Convert the reference's MXNet checkpoints (rcnn_coco-0008.params and the
like) into a params file of the port, without mxnet and without JAX (the
counterpart of the repository's tools/convert_reference_params.py, which
imports the JAX package).

    python -m relation_tpu_torch.tools.convert_reference_params \\
        --src rcnn_coco-0008.params --cfg experiments/cfgs/<name>.yaml \\
        --out params.msgpack [--use-test-weights] [--tiny] [--device cpu]

Input: an ``mx.nd.save`` file (parsed here, every format version of mxnet
1.x: NDARRAY_V2, NDARRAY_V1 and the legacy one whose magic is the rank), or
an .npz / pickle of {name: array}; ``arg:`` / ``aux:`` prefixes are
dropped. The model of ``--cfg`` is the template: built, filled by
``init_params(seed=0)``, then every leaf the file names is replaced through
core/checkpoint.py::reference_name_map and ``reference_transform`` (MXNet's
[out, in, kh, kw] convs and [out, in] denses are the port's layouts; the
first dense after the ROI pool is permuted from (c, h, w) to (h, w, c); the
grouped linear_out_* become [G, F, E]). Leaves the file lacks stay at their
init and are listed, as are the file's arrays no leaf takes.
``--use-test-weights`` swaps the std-folded ``bbox_pred_*_test`` shadows in
(reference lib/utils/load_model.py:46-67; evaluate them with
TRAIN.BBOX_NORMALIZATION_PRECOMPUTED off).

Output: core/checkpoint.py::save_params, the JAX package's file format (so
either package reads it), tagged ``{"source": "mxnet_reference",
"roi_method": "pool", "test_weights": "true"|"false"}``: the reference head
is MXNet's rounding max-pool ROIPooling, and experiments/test.py evaluates a
file with that tag in its parity mode.
"""

from __future__ import annotations

import argparse
import pickle
import struct

import numpy as np

MX_MAGIC = 0x112          # kMXAPINDArrayListMagic (mxnet ndarray.cc)
_V2, _V1 = 0xF993FAC9, 0xF993FAC8
_DTYPES = {0: np.float32, 1: np.float64, 2: np.float16, 3: np.uint8,
           4: np.int32, 5: np.int8, 6: np.int64}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def load_mxnet_params(path: str) -> dict[str, np.ndarray]:
    """{name: array} of an mx.nd.save file: the list magic, a reserved
    word, the arrays (dense storage; NDARRAY_V2, NDARRAY_V1 or the legacy
    header whose first word is the rank), then the names. A file that does
    not start with the magic is refused."""
    with open(path, "rb") as f:
        data = f.read()
    off = 0

    def read(fmt):
        nonlocal off
        v = struct.unpack_from(fmt, data, off)
        off += struct.calcsize(fmt)
        return v[0] if len(v) == 1 else v

    magic = read("<Q")
    if magic != MX_MAGIC:
        raise ValueError(f"{path}: not an mx.nd.save file (magic {magic:#x})")
    read("<Q")                                   # reserved
    arrays = []
    for _ in range(read("<Q")):
        head = read("<I")
        if head == _V2:
            if read("<I") != 1:                  # kDefaultStorage
                raise ValueError(f"{path}: sparse arrays are not supported")
            ndim = read("<I")
        elif head == _V1:
            ndim = read("<I")
        else:                                    # legacy: the word is the rank
            ndim = head
        shape = tuple(read("<Q") for _ in range(ndim))
        read("<II")                              # context (device type, id)
        dtype = np.dtype(_DTYPES[read("<I")])
        count = int(np.prod(shape)) if shape else 1
        arr = np.frombuffer(data, dtype=dtype, count=count, offset=off)
        off += arr.nbytes
        arrays.append(arr.reshape(shape).copy())
    names = []
    for _ in range(read("<Q")):
        n = read("<Q")
        names.append(data[off:off + n].decode())
        off += n
    return dict(zip(names, arrays))


def save_mxnet_params(path: str, named: dict, version: str = "v2") -> str:
    """Write {name: array} as mx.nd.save does (dense arrays on the CPU
    context; ``version`` "v2", "v1" or "legacy" for the array headers)."""
    buf = bytearray(struct.pack("<QQQ", MX_MAGIC, 0, len(named)))
    for arr in named.values():
        arr = np.ascontiguousarray(arr)
        if version == "v2":
            buf += struct.pack("<III", _V2, 1, arr.ndim)
        elif version == "v1":
            buf += struct.pack("<II", _V1, arr.ndim)
        elif version == "legacy":
            buf += struct.pack("<I", arr.ndim)
        else:
            raise ValueError(version)
        buf += struct.pack(f"<{arr.ndim}Q", *arr.shape)
        buf += struct.pack("<III", 1, 0, _CODES[arr.dtype])
        buf += arr.tobytes()
    buf += struct.pack("<Q", len(named))
    for name in named:
        enc = name.encode()
        buf += struct.pack("<Q", len(enc)) + enc
    with open(path, "wb") as f:
        f.write(bytes(buf))
    return path


def load_any(path: str) -> dict[str, np.ndarray]:
    """{name: array} of an .npz, a pickle or an mx.nd.save file."""
    if path.endswith(".npz"):
        return dict(np.load(path))
    if path.endswith((".pkl", ".pickle")):
        with open(path, "rb") as f:
            return {k: np.asarray(v) for k, v in pickle.load(f).items()}
    return load_mxnet_params(path)


def strip_prefixes(raw: dict) -> dict:
    """MXNet checkpoints prefix their entries with 'arg:' / 'aux:'."""
    return {(k.split(":", 1)[1] if ":" in k else k): v for k, v in raw.items()}


def convert(raw: dict, model, use_test_weights: bool = False):
    """Fill a state_dict of ``model`` from reference-named arrays: leaves the
    arrays name take them (in the port's layout), the others keep the
    model's current values. Returns (state_dict of float32 CPU tensors,
    sorted missing state_dict keys, sorted unused reference names)."""
    import torch
    from relation_tpu_torch.core.checkpoint import (reference_name_map,
                                                    reference_transform)
    raw = strip_prefixes(raw)
    if use_test_weights:
        for base in ("bbox_pred_weight", "bbox_pred_bias"):
            if base + "_test" in raw:
                raw[base] = raw[base + "_test"]
    sd = {k: v.detach().to(torch.float32).cpu().clone()
          for k, v in model.state_dict().items()}
    names = reference_name_map(model)
    taken = set()
    for mx_name, (key, tag) in names.items():
        if mx_name in raw:
            sd[key] = torch.from_numpy(reference_transform(
                tag, raw[mx_name], tuple(sd[key].shape)))
            taken.add(key)
    missing = sorted(set(sd) - taken)
    unused = sorted(set(raw) - {mx for mx, (k, _) in names.items() if k in taken})
    return sd, missing, unused


def reference_layout(tag: str, w: np.ndarray) -> np.ndarray:
    """The inverse of core/checkpoint.py::reference_transform: a tensor of
    the port, as a numpy array, in the MXNet layout of ``tag``."""
    from relation_tpu_torch.core.checkpoint import POOLED_HW
    w = np.asarray(w, np.float32)
    if tag == "dense_chw":
        o = w.shape[0]
        c = w.shape[1] // (POOLED_HW * POOLED_HW)
        return np.ascontiguousarray(
            w.reshape(o, POOLED_HW, POOLED_HW, c).transpose(0, 3, 1, 2)
            .reshape(o, -1))
    if tag == "grouped":
        g, f, e = w.shape
        return np.ascontiguousarray(w.transpose(0, 2, 1).reshape(g * e, f, 1, 1))
    return np.ascontiguousarray(w)


def reference_arrays(model) -> dict[str, np.ndarray]:
    """The model's parameters under the reference's names and layouts, with
    MXNet's 'arg:' / 'aux:' prefixes (aux: the BatchNorm moving
    statistics): what ``convert`` turns back into the model bit for bit."""
    from relation_tpu_torch.core.checkpoint import reference_name_map
    sd = model.state_dict()
    out = {}
    for mx_name, (key, tag) in reference_name_map(model).items():
        prefix = "aux:" if "moving" in mx_name else "arg:"
        out[prefix + mx_name] = reference_layout(
            tag, sd[key].detach().float().cpu().numpy())
    return out


def main(argv=None) -> dict:
    """Converts; returns {"out", "missing", "unused", "model"}."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--src", required=True)
    p.add_argument("--cfg", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--use-test-weights", action="store_true")
    p.add_argument("--tiny", action="store_true",
                   help="tiny-trunk template (must match the saved model)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from relation_tpu_torch.config.defaults import load_config
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.checkpoint import save_params
    from relation_tpu_torch.core.trainer import build_model

    cfg = load_config(args.cfg)
    model = init_params(build_model(cfg, tiny=args.tiny, device=args.device),
                        seed=0)
    sd, missing, unused = convert(load_any(args.src), model,
                                  use_test_weights=args.use_test_weights)
    model.load_state_dict(sd)
    print(f"converted; {len(missing)} missing (left at init), "
          f"{len(unused)} unused reference arrays")
    for m in missing[:20]:
        print("  missing:", m)
    for u in unused[:20]:
        print("  unused:", u)
    save_params(args.out, model, meta={
        "source": "mxnet_reference", "roi_method": "pool",
        "test_weights": str(bool(args.use_test_weights)).lower()})
    print("wrote", args.out)
    return {"out": args.out, "missing": missing, "unused": unused,
            "model": model}


if __name__ == "__main__":
    main()
