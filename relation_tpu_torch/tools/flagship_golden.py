"""Production-shape gate: the port's flagship at 608x1024 against the JAX
package's answer on the same weights and image.

    python3 -m relation_tpu_torch.tools.flagship_golden --check [--device cpu]

The weights are ``convert.py::init_params(seed=0)`` of the flagship (numpy
RandomState: the same f32 values on any machine), with the four prediction
layers of tools/calibrate.py::CALIBRATED multiplied by the factors stored in
the golden file, on the host, in one numpy expression
(``calibrate.apply_factors``). The factors were computed once, on the CPU,
by ``calibrate.calibrate_heads`` on the gate's image: from init_params alone
the RPN logits reach +-500 and every proposal is clipped to the whole image,
so the detections would be degenerate boxes. The image is
``RandomState(7).randn(12, 304, 512) * 40`` with im_info [600, 1000, 1.667],
as tools/flagship_golden.py has it.

The check runs two requests through ``entry()``'s model on the card (its
kernels), or on the CPU with ``--device cpu`` (the plain versions):

1. The detections, computing in f32 (TPU.COMPUTE_DTYPE and TPU.HEAD_DTYPE
   float32), held in the bands of tools/flagship_golden.py: each of the
   golden's top 50 detections matched by the best-IoU detection of its class
   (+1 convention) at IoU >= 0.95 and |score delta| <= 2e-2, the mean top-50
   score within 5e-3 relative, the detection count within max(2, 5%). At
   this network's scores (mean top-50 0.0063) the per-detection score band
   cannot bite: the IoU and mean bands do.
2. The trunk feature of the flagship's own configuration (bf16 trunk: the
   stem kernel and cuDNN's bf16 convolutions), at every 8th row and column
   and the last ones, against the JAX package's bf16 trunk on the same
   weights: mean |delta| / mean |x| <= TRUNK_RTOL.

Why the detections are held in f32: in bf16 the calibrated random network is
ill-conditioned at this shape. On the CPU the JAX package's own detections
on the image times (1 + 1e-6 N(0, 1)) miss its own bands at 16 of the top 50
(a best IoU of 0 for some, the mean top-50 score 4.7% off), and the port's
bf16 trunk feature is 1% from JAX's (`tests/flagship_port_golden.py
--bisect --bf16`). In f32 both hold: the JAX package under that noise and
the port against it keep every top-50 detection at IoU >= 0.9999 (PERF.md
section 6). So the bf16 path is held at its trunk, where the two packages'
rounding leaves about 1%, and no band on its detections.

The golden file, tests/golden/flagship_port.npz, holds the JAX package's
detections and bf16 trunk sample on those weights (its make_predict_fn and
features_and_rpn, the weights carried across by
``convert.py::to_jax_params``), written by ``tests/flagship_port_golden.py
--generate`` on the CPU. Exits 1 on a miss.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from relation_tpu_torch.tools.calibrate import apply_factors

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                      "tests", "golden", "flagship_port.npz")
TOP_K = 50          # detections pinned by box/class/score
IOU_MIN = 0.95      # golden box vs best same-class new box
SCORE_ATOL = 2e-2   # per-detection score band
MEAN_RTOL = 5e-3    # summary-score band
SEED, IMAGE_SEED = 0, 7
IM_INFO = (600.0, 1000.0, 1.667)
# the bf16 trunk feature against JAX's: mean |delta| / mean |x| (the two
# packages' bf16 rounding leaves about 1e-2, a fault about 1), and the
# spacing of the rows and columns it is read at
TRUNK_RTOL = 3e-2
TRUNK_STRIDE = 8


def gate_image(size=(608, 1024)) -> np.ndarray:
    """The s2d image of the gate, [12, H/2, W/2] f32."""
    H, W = size
    return (np.random.RandomState(IMAGE_SEED).randn(12, H // 2, W // 2)
            .astype(np.float32) * 40.0)


def gate_cfg(tiny: bool = False, dtype: str | None = "float32"):
    """The flagship config computing in ``dtype`` (None: the flagship's
    own, a bf16 trunk; ``tiny``: the tiny proposal counts)."""
    from relation_tpu_torch.entry import flagship_cfg
    cfg = flagship_cfg(tiny_shapes=tiny)
    if dtype is not None:
        cfg.TPU.COMPUTE_DTYPE = cfg.TPU.HEAD_DTYPE = dtype
    return cfg


def trunk_sample(feat) -> np.ndarray:
    """The trunk feature [H, W, C] at every TRUNK_STRIDE-th row and column
    and the last ones, f32."""
    feat = np.asarray(feat, np.float32)
    H, W = feat.shape[:2]
    rows = sorted(set(range(0, H, TRUNK_STRIDE)) | {H - 1})
    cols = sorted(set(range(0, W, TRUNK_STRIDE)) | {W - 1})
    return feat[rows][:, cols]


def trunk_error(new, gold) -> float:
    """mean |new - gold| / mean |gold|."""
    new, gold = np.asarray(new, np.float64), np.asarray(gold, np.float64)
    return float(np.abs(new - gold).mean() / max(np.abs(gold).mean(), 1e-30))


def sorted_dets(dets: np.ndarray) -> np.ndarray:
    """The real rows of a [max_per_image, 6] detection array (class >= 0),
    by descending score, stable, as tools/flagship_golden.py sorts them."""
    dets = np.asarray(dets, np.float32)
    dets = dets[dets[:, 0] >= 0]
    return dets[np.argsort(-dets[:, 1], kind="stable")]


def iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of one box a [4] vs boxes b [M, 4] (+1 width convention)."""
    ix = np.maximum(0, np.minimum(a[2], b[:, 2]) - np.maximum(a[0], b[:, 0]) + 1)
    iy = np.maximum(0, np.minimum(a[3], b[:, 3]) - np.maximum(a[1], b[:, 1]) + 1)
    inter = ix * iy
    ua = ((a[2] - a[0] + 1) * (a[3] - a[1] + 1)
          + (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1) - inter)
    return inter / np.maximum(ua, 1e-9)


def compare(new: np.ndarray, gold: np.ndarray, n_gold: int,
            mean_gold: float) -> tuple[list, dict]:
    """(misses, margins) of sorted detections ``new`` against the golden's,
    in tools/flagship_golden.py's bands. ``margins``: the worst best-IoU
    and the worst |score delta| over the matched top-K."""
    errs = []
    if abs(len(new) - n_gold) > max(2, int(0.05 * n_gold)):
        errs.append(f"det count {len(new)} vs golden {n_gold}")
    m_new = float(new[:TOP_K, 1].mean()) if len(new) else float("nan")
    if not abs(m_new - mean_gold) <= MEAN_RTOL * max(abs(mean_gold), 1e-3):
        errs.append(f"mean top-{TOP_K} score {m_new:.5f} vs {mean_gold:.5f}")
    worst_iou, worst_ds = 1.0, 0.0
    for i, g in enumerate(gold[:TOP_K]):
        same = new[new[:, 0] == g[0]]
        if not len(same):
            errs.append(f"top-{i}: class {int(g[0])} vanished")
            worst_iou = 0.0
            continue
        ious = iou(g[2:6], same[:, 2:6])
        j = int(np.argmax(ious))
        ds = abs(float(same[j, 1]) - float(g[1]))
        worst_iou, worst_ds = min(worst_iou, float(ious[j])), max(worst_ds, ds)
        if ious[j] < IOU_MIN:
            errs.append(f"top-{i} cls {int(g[0])}: best IoU {ious[j]:.3f}")
        elif ds > SCORE_ATOL:
            errs.append(f"top-{i} cls {int(g[0])}: score {same[j, 1]:.4f} "
                        f"vs {g[1]:.4f}")
    return errs, {"worst_iou": worst_iou, "worst_dscore": worst_ds,
                  "n_dets": len(new), "mean_top50": m_new}


def port_outputs(factors, dtype: str | None = "float32", device="cuda",
                 tiny: bool = False, size=(608, 1024)) -> dict:
    """The port's predict outputs on the gate's image: ``entry()``'s
    flagship model (init_params(seed=0)) computing in ``dtype``
    (gate_cfg), its CALIBRATED layers scaled by ``factors``, on ``device``.
    ``tiny``: the tiny proposal counts and the tiny trunk (a CPU rehearsal
    of the code)."""
    import torch
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.predictor import build_predict_fn
    from relation_tpu_torch.core.trainer import build_model
    from relation_tpu_torch.entry import entry
    cfg = gate_cfg(tiny, dtype)
    if tiny:
        model = init_params(build_model(cfg, tiny=True, device=device), SEED)
        predict = build_predict_fn(model, cfg)
    else:
        predict, _ = entry("flagship", device=device, seed=SEED, cfg=cfg)
        model = predict.model
    apply_factors(model, factors)
    dev = next(model.parameters()).device
    # f32 convolutions and products in f32, not TF32 (a fresh process's
    # default for cuDNN)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    image = torch.from_numpy(gate_image(size)).to(dev)
    im_info = torch.tensor(IM_INFO, device=dev)
    with torch.no_grad():
        return predict(image, im_info)


def port_dets(factors, device="cuda", tiny: bool = False, size=(608, 1024)):
    """The port's sorted detections on the gate, in f32."""
    out = port_outputs(factors, "float32", device, tiny, size)
    return sorted_dets(out["dets"].cpu().numpy())


def port_trunk(factors, device="cuda", tiny: bool = False, size=(608, 1024)):
    """trunk_sample of the port's trunk feature on the gate, in the
    flagship's own (bf16 trunk) configuration."""
    out = port_outputs(factors, None, device, tiny, size)
    return trunk_sample(out["feat"].float().cpu().numpy())


def hold_trunk(new, gold) -> tuple[list, float]:
    """(misses, relative error) of a trunk sample against the golden's."""
    rel = trunk_error(new, gold)
    errs = [] if rel <= TRUNK_RTOL else [
        f"bf16 trunk feature {rel:.4e} from JAX's (band {TRUNK_RTOL:g})"]
    return errs, rel


def check(device="cuda") -> tuple[list, dict]:
    """Run the gate against tests/golden/flagship_port.npz; returns
    (misses, margins)."""
    with np.load(GOLDEN) as z:
        ref = {k: z[k] for k in z.files}
    new = port_dets(ref["factors"], device=device)
    errs, margins = compare(new, ref["dets"], int(ref["n_dets"]),
                            float(ref["mean_top50"]))
    trunk_errs, margins["trunk_rel"] = hold_trunk(
        port_trunk(ref["factors"], device=device), ref["trunk_bf16"])
    return errs + trunk_errs, margins


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    errs, margins = check(args.device)
    if errs:
        print("FLAGSHIP PORT GOLDEN MISMATCH:")
        for e in errs[:20]:
            print(" ", e)
        print(f"margins {margins}")
        return 1
    print(f"flagship port golden OK: {margins['n_dets']} dets, top-{TOP_K} "
          f"matched (IoU>={IOU_MIN}, |ds|<={SCORE_ATOL}), worst IoU "
          f"{margins['worst_iou']:.4f}, worst |ds| {margins['worst_dscore']:.2e}, "
          f"mean {margins['mean_top50']:.5f}; bf16 trunk "
          f"{margins['trunk_rel']:.4e} from JAX's (band {TRUNK_RTOL:g})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
