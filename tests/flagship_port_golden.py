"""Writes tests/golden/flagship_port.npz, the production-shape gate of
relation_tpu_torch/tools/flagship_golden.py: the JAX package's flagship
detections and bf16 trunk feature at 608x1024 on weights that the port
rebuilds without JAX.

    JAX_PLATFORMS=cpu python tests/flagship_port_golden.py --generate
    JAX_PLATFORMS=cpu python tests/flagship_port_golden.py --measure

The weights: ``convert.py::init_params(build_model(flagship_cfg()),
seed=0)`` (numpy RandomState), then the four factors of
relation_tpu_torch/tools/calibrate.py::calibrate_heads, computed here on the
CPU by the port's plain path in f32 on the gate's image, applied to a fresh
copy by ``calibrate.apply_factors`` (one numpy product a layer, which the
check repeats). The answer: relation_tpu's make_predict_fn in f32 on those
weights (carried across by ``convert.py::to_jax_params``; its Pallas kernels
as the JAX package runs them on the CPU), and its features_and_rpn in the
flagship's own bf16 trunk, read by ``trunk_sample``. The file holds
``dets`` (sorted by score), ``n_dets``, ``mean_top50``, ``factors``,
``trunk_bf16`` (f32) and the config's name.

``--measure`` writes nothing: it prints the margins of the port's plain
path on the CPU against the committed file, and of the JAX package's CPU
predict on the flax init against tests/golden/flagship_tpu.npz (the TPU
golden of tools/flagship_golden.py), with jax_threefry_partitionable on
(JAX's default) and off. ``--bisect [--bf16]`` prints the
port's stages against the JAX package's at 608x1024 on the gate's weights
and the JAX package's own spread under 1e-6 input noise, in the gate's f32
or in bf16. Each takes a minute or two and about 2 GiB.

This file imports JAX, so it lives with the tests and never in the package.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

from relation_tpu_torch.tools import flagship_golden as gate
from relation_tpu_torch.tools.calibrate import apply_factors, calibrate_heads

CFG_NAME = "flagship"


def gate_weights(tiny: bool = False, size=(608, 1024), factors=None,
                 dtype: str | None = "float32"):
    """(cfg, port model on the CPU with the gate's weights, factors) in
    ``dtype`` (gate_cfg); ``factors`` None calibrates an f32 model on the
    gate's image and applies its factors to a fresh copy."""
    import torch
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.predictor import make_predict_fn
    from relation_tpu_torch.core.trainer import build_model

    def fresh(cfg):
        return init_params(build_model(cfg, tiny=tiny, device="cpu"), gate.SEED)
    if factors is None:
        f32 = gate.gate_cfg(tiny)
        model = fresh(f32)
        factors = calibrate_heads(model, make_predict_fn(model, f32),
                                  torch.from_numpy(gate.gate_image(size)),
                                  torch.tensor(gate.IM_INFO))
    cfg = gate.gate_cfg(tiny, dtype)
    return cfg, apply_factors(fresh(cfg), factors), factors


def _jax(cfg, model, tiny: bool = False):
    """(JAX model, params) of the port model's weights."""
    import jax.numpy as jnp
    from flax.traverse_util import unflatten_dict
    from relation_tpu.core.trainer import build_model
    from relation_tpu_torch.convert import to_jax_params
    return build_model(cfg, tiny=tiny), unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in
         to_jax_params(model.state_dict()).items()})


def jax_dets(cfg, model, tiny: bool = False, size=(608, 1024)) -> np.ndarray:
    """The JAX package's sorted detections of the gate's image on the port
    model's weights."""
    import jax.numpy as jnp
    from relation_tpu.core.predictor import make_predict_fn
    jm, params = _jax(cfg, model, tiny)
    H, W = size
    predict = make_predict_fn(jm, cfg, (H // 16, W // 16))
    out = predict(params, jnp.asarray(gate.gate_image(size)),
                  jnp.asarray(gate.IM_INFO, jnp.float32))
    return gate.sorted_dets(np.asarray(out["dets"]))


def jax_trunk(cfg, model, tiny: bool = False, size=(608, 1024)) -> np.ndarray:
    """trunk_sample of the JAX package's trunk feature of the gate's image
    on the port model's weights."""
    import jax
    import jax.numpy as jnp
    jm, params = _jax(cfg, model, tiny)
    feat, _, _ = jax.jit(lambda p, x: jm.apply(
        {"params": p}, x, method=type(jm).features_and_rpn))(
            params, jnp.asarray(gate.gate_image(size)))
    return gate.trunk_sample(np.asarray(feat.astype(jnp.float32)))


def golden_arrays(tiny: bool = False, size=(608, 1024)) -> dict:
    """The arrays of the golden file."""
    cfg, model, factors = gate_weights(tiny, size)
    dets = jax_dets(cfg, model, tiny, size)
    bf16, model, _ = gate_weights(tiny, size, factors, dtype=None)
    trunk = jax_trunk(bf16, model, tiny, size)
    return {"dets": dets, "n_dets": np.int32(len(dets)),
            "mean_top50": np.float32(dets[:gate.TOP_K, 1].mean()),
            "factors": factors, "trunk_bf16": trunk,
            "cfg": np.asarray(CFG_NAME)}


def generate(path: str = gate.GOLDEN) -> None:
    arrays = golden_arrays()
    np.savez(path, **arrays)
    print(f"wrote {os.path.relpath(path)}: {int(arrays['n_dets'])} dets, mean "
          f"top-{gate.TOP_K} {float(arrays['mean_top50']):.5f}, factors "
          f"{arrays['factors'].tolist()}, bf16 trunk sample "
          f"{arrays['trunk_bf16'].shape}")


def _rel(a, b) -> str:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (f"max |d| {np.abs(a - b).max():.3e} of max |x| {np.abs(b).max():.3e}"
            f", mean |d| / mean |x| {np.abs(a - b).mean() / np.abs(b).mean():.3e}")


def bisect(dtype: str = "float32", noise: float = 1e-6) -> None:
    """The port's stages against the JAX package's at 608x1024 on the gate's
    weights (the committed factors), both packages computing in ``dtype``,
    each stage fed the JAX stage before it (as tests/test_torch_flagship.py
    does at the tiny shape), then the JAX package's own spread: its
    detections on the image times (1 + noise x N(0, 1)) against its own on
    the image, in the gate's bands."""
    import jax
    import jax.numpy as jnp
    import torch
    from flax.traverse_util import unflatten_dict
    from relation_tpu.core.predictor import make_predict_fn as j_predict_fn
    from relation_tpu.core.trainer import build_model as j_build
    from relation_tpu_torch.convert import to_jax_params
    from relation_tpu_torch.core.predictor import make_predict_fn
    tag = "f32" if dtype == "float32" else dtype
    with np.load(gate.GOLDEN) as z:
        cfg, model, _ = gate_weights(factors=z["factors"], dtype=dtype)
    params = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in
                             to_jax_params(model.state_dict()).items()})
    jm = j_build(cfg)
    P = {"params": params}
    image = gate.gate_image()
    im_info = np.asarray(gate.IM_INFO, np.float32)
    nongt = int(cfg.TEST.RPN_POST_NMS_TOP_N)
    j_out = j_predict_fn(jm, cfg, (38, 64))(params, jnp.asarray(image),
                                            jnp.asarray(im_info))
    j_dets = gate.sorted_dets(j_out["dets"])
    feat_j, cls_j, bbox_j = jax.jit(lambda p, x: jm.apply(
        p, x, method=type(jm).features_and_rpn))(P, jnp.asarray(image))
    rois_j = np.asarray(j_out["rois"])
    cs_j, bp_j, fc2_j = jax.jit(lambda p, f, r: jm.apply(
        p, f, r, nongt, method=type(jm).head))(P, feat_j, jnp.asarray(rois_j))
    ln_j = jax.jit(lambda p, a, b, r, c: jm.apply(
        p, a, b, r, c, jnp.asarray(im_info), float(cfg.TEST.LEARN_NMS_CLASS_SCORE_TH),
        method=type(jm).learn_nms))(P, cs_j, bp_j, jnp.asarray(rois_j), fc2_j)
    T = lambda x: torch.from_numpy(np.array(x, np.float32))
    with torch.no_grad():
        out = make_predict_fn(model, cfg)(T(image), T(im_info))
        p_dets = gate.sorted_dets(out["dets"].numpy())
        print(f"[{tag}] port vs JAX, whole predict: "
              f"{gate.compare(p_dets, j_dets, len(j_dets), float(j_dets[:50, 1].mean()))}",
              flush=True)
        for name, want in (("feat", feat_j), ("rpn_cls", cls_j), ("rpn_bbox", bbox_j)):
            print(f"[{tag}] {name}: {_rel(out[name].float().numpy(), want)}", flush=True)
        rois_p = out["rois"].numpy()
        same = np.mean([gate.iou(r, rois_j).max() > 0.99 for r in rois_p])
        exact = np.mean(np.all(rois_p == rois_j, axis=1))
        print(f"[{tag}] rois (own trunk): {exact:.3f} equal row for row, "
              f"{same:.3f} matched at IoU > 0.99", flush=True)
        from relation_tpu_torch.models.rpn import generate_proposals
        from relation_tpu_torch.ops.anchors import generate_anchors
        ca, cb = T(cls_j), T(bbox_j)
        base = torch.as_tensor(generate_anchors(16, tuple(cfg.network.ANCHOR_RATIOS),
                                                tuple(cfg.network.ANCHOR_SCALES)),
                               dtype=torch.float32)
        rois_jp = generate_proposals(
            torch.softmax(ca, dim=-1)[..., 1], cb, base, T(im_info), 16,
            int(cfg.TEST.RPN_PRE_NMS_TOP_N), nongt, float(cfg.TEST.RPN_NMS_THRESH),
            float(cfg.TEST.RPN_MIN_SIZE))[0].numpy()
        print(f"[{tag}] rois from JAX's RPN outputs: "
              f"{np.mean(np.all(rois_jp == rois_j, axis=1)):.3f} equal row for row, "
              f"{_rel(rois_jp, rois_j)}", flush=True)
        cs, bp, fc2 = model.head(T(feat_j).to(out["feat"].dtype), T(rois_j), nongt)
        for name, a, b in (("cls_score", cs, cs_j), ("bbox_pred", bp, bp_j),
                           ("fc2", fc2, fc2_j)):
            print(f"[{tag}] head on JAX's feat and rois, {name}: "
                  f"{_rel(a.float().numpy(), b)}", flush=True)
        ln = model.learn_nms(T(cs_j), T(bp_j), T(rois_j), T(fc2_j), T(im_info),
                             float(cfg.TEST.LEARN_NMS_CLASS_SCORE_TH))
        for name in ("sorted_score", "sorted_bbox", "nms_multi_score"):
            print(f"[{tag}] learned NMS on JAX's head outputs, {name}: "
                  f"{_rel(ln[name].numpy(), ln_j[name])}", flush=True)
    rng = np.random.RandomState(11)
    noisy = image * (1 + noise * rng.randn(*image.shape).astype(np.float32))
    n_dets = gate.sorted_dets(j_predict_fn(jm, cfg, (38, 64))(
        params, jnp.asarray(noisy), jnp.asarray(im_info))["dets"])
    print(f"[{tag}] JAX on the image x (1 + {noise:g} N(0,1)) vs JAX: "
          f"{gate.compare(n_dets, j_dets, len(j_dets), float(j_dets[:50, 1].mean()))}",
          flush=True)


def measure() -> None:
    """The two CPU margins recorded in PERF.md."""
    import time
    t0 = time.perf_counter()
    errs, margins = gate.check(device="cpu")
    print(f"port plain path (CPU; f32 detections, bf16 trunk) vs "
          f"flagship_port.npz: "
          f"{len(errs)} misses {errs[:5]}; margins {margins}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    import flagship_golden as jax_tool                 # tools/flagship_golden.py
    ref = np.load(jax_tool.GOLDEN)
    new = jax_tool._dets()
    errs, margins = gate.compare(new, ref["dets"], int(ref["n_dets"]),
                                 float(ref["mean_top50"]))
    print(f"JAX package (CPU) vs flagship_tpu.npz: {len(errs)} misses "
          f"{errs[:5]}; margins {margins}; golden top-1 "
          f"{ref['dets'][0].tolist()}, CPU top-1 {new[0].tolist()}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gold = ref["dets"]
    boxes, counts = np.unique(gold[:, 2:6], axis=0, return_counts=True)
    print(f"flagship_tpu.npz: {len(gold)} detections, classes "
          f"{sorted(set(gold[:, 0].astype(int).tolist()))}, scores "
          f"{gold[:, 1].min():.4f}-{gold[:, 1].max():.4f}, distinct boxes "
          f"(x1, y1, x2, y2: count) "
          f"{[(b.round(2).tolist(), int(c)) for b, c in zip(boxes, counts)]}",
          flush=True)
    import jax
    jax.config.update("jax_threefry_partitionable", False)
    new = jax_tool._dets()
    errs, margins = gate.compare(new, ref["dets"], int(ref["n_dets"]),
                                 float(ref["mean_top50"]))
    print(f"JAX package (CPU, jax_threefry_partitionable=False) vs "
          f"flagship_tpu.npz: {len(errs)} misses {errs[:3]}; top-1 "
          f"{new[0].tolist()}", flush=True)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--generate", action="store_true")
    g.add_argument("--measure", action="store_true")
    g.add_argument("--bisect", action="store_true")
    p.add_argument("--bf16", action="store_true",
                   help="--bisect: trunk and head in bf16 in both packages")
    a = p.parse_args()
    if a.generate:
        generate()
    elif a.measure:
        measure()
    else:
        bisect("bfloat16" if a.bf16 else "float32")
