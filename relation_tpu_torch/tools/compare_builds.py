"""Kernels built from this checkout's sources and from another checkout's, on
one CUDA card: the same seeded inputs through both libraries behind the same
wrapper, outputs compared, times taken in turns (other, this, this, other)
in one process.

    python3 -m relation_tpu_torch.tools.compare_builds --other DIR/relation_tpu_torch/csrc [--only NAME]

- bias_attention (rows 7 and 8): chip_smoke.py's shapes (80 classes at N=100
  and N=150, 16 of 80 at N=150, 4 classes at N=408), outputs bit for bit.
- nms_kernel (row 4): tools/ablate_nms.py's cases (the proposals' shape with
  chip_smoke.py's boxes and a crowded class, the classic tail); both keep
  masks against the plain version, bit for bit. Either build may be the
  two-pass bitmask design.
- geom_bias (rows 1 and 3): tools/ablate_geom_bias.py's shapes; each build in
  the chip check's band against the plain version (|exp error| <= 1e-5,
  |log error| <= 1e-4 where acc > 1e-2), the largest difference between the
  builds, and for the skip form (row 3) its active rows against the same
  build's unskipped kernel, bit for bit.
- geom_bias_bwd (row 2, which recomputes row 1's acc): 80 classes at
  N=M=100 and one class at 316x300, without d_pos as the model runs it;
  d_W within 1e-4 of its maximum of the plain version's in both builds.

Prints the card's name and power limit first. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from relation_tpu_torch.ops.embeddings import (extract_multi_position_matrix_t,
                                               extract_position_matrix_t)
from relation_tpu_torch.ops.kernels import _build
from relation_tpu_torch.ops.kernels import bias_attention as BA
from relation_tpu_torch.ops.kernels import geom_bias as GB
from relation_tpu_torch.ops.kernels import nms_kernel as NK
from relation_tpu_torch.tools import ablate_geom_bias, ablate_nms
from relation_tpu_torch.tools._ablate import build_variants, print_card, time_ms
from relation_tpu_torch.tools.ablate_attention import boxes

TURNS = ("other", "this", "this", "other")


def in_turns(name, libs, call):
    """({build: output}, "other t; this t; this t; other t") of ``call``
    with each build's library of ``name`` behind the wrapper."""
    outs, times = {}, []
    for which in TURNS:
        _build._libs[name] = libs[which]
        outs[which] = call()
        times.append(f"{which} {time_ms(call, reps=21):.4f}")
    _build._libs.pop(name, None)
    return outs, "; ".join(times)


def compare_attention(libs, dev, rng):

    def tens(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)
    G, D, Fd, E = 16, 64, 128, 8
    w, b = tens(rng.randn(64, G) * 0.1), tens(rng.randn(G) * 0.05)
    for C, N, n_active in ((80, 100, 80), (80, 150, 80), (80, 150, 16),
                           (4, 408, 4)):
        pos = extract_multi_position_matrix_t(
            tens(np.stack([boxes(rng, N) for _ in range(C)], 1))).contiguous()
        bias = GB.geom_bias_reference(pos, w, b).contiguous()
        del pos
        q, k = tens(rng.randn(C, N, G * D) * 0.5), tens(rng.randn(C, N, G * D) * 0.5)
        v, wl = tens(rng.randn(C, N, Fd)), tens(rng.randn(G, Fd, E) * 0.1)
        act = np.zeros(C, np.int32)
        act[rng.choice(C, n_active, replace=False)] = 1
        active = torch.tensor(act, device=dev)
        on = active.bool()
        if n_active == C:
            def call():
                return BA.fused_bias_attention(bias, q, k, v, wl)
        else:
            def call():
                return BA.fused_bias_attention_skip(bias, q, k, v, wl, active)
        outs, times = in_turns("bias_attention", libs, call)
        same = torch.equal(outs["other"][on], outs["this"][on])
        row = "row 7" if n_active == C else "row 8"
        print(f"{row} C={C} N={N} active={n_active}: outputs bit-equal: {same}; "
              f"ms {times}", flush=True)


def compare_nms(libs, dev, rng):
    for label, bT, v, th, blk, mk in ablate_nms.cases(dev):
        want = NK.nms_keep_sorted_reference(bT, v, th, blk, mk)
        same, times = {}, []
        for which in TURNS:
            lib = libs[which]
            same[which] = torch.equal(
                ablate_nms.keep_with(lib, bT, v, th, blk, mk), want)
            t = time_ms(lambda: ablate_nms.keep_with(lib, bT, v, th, blk, mk),
                        reps=21)
            times.append(f"{which} {t:.4f}")
        print(f"row 4 {label} max_keep={mk}: keep masks equal to the plain "
              f"version's: other {same['other']}, this {same['this']}; ms "
              f"{'; '.join(times)}", flush=True)


def band(got, want):
    """(max |exp error|, max |log error| where acc > 1e-2) of a bias."""
    clear = want.exp() > 1e-2
    return (float((got.exp() - want.exp()).abs().max()),
            float((got - want)[clear].abs().max()))


def compare_geom_bias(libs, dev, rng):
    G = 16
    w = torch.tensor(rng.randn(64, G) * 0.1, dtype=torch.float32, device=dev)
    b = torch.tensor(rng.randn(G) * 0.05, dtype=torch.float32, device=dev)
    for label, pos, active in ablate_geom_bias.cases(dev, rng):
        outs, times = in_turns("geom_bias", libs, lambda: GB._launch(
            pos, w, b, 100.0, active=active))
        on = slice(None) if active is None else active.bool()
        want = GB.geom_bias_reference(pos[on], w, b)
        errs = {k: band(outs[k][on], want) for k in ("other", "this")}
        ok = all(e <= 1e-5 and el <= 1e-4 for e, el in errs.values())
        diff = float((outs["other"][on].exp() - outs["this"][on].exp()).abs().max())
        extra = ""
        if active is not None:
            full = {}
            for which in ("other", "this"):
                _build._libs["geom_bias"] = libs[which]
                full[which] = torch.equal(GB._launch(pos, w, b, 100.0)[on],
                                          outs[which][on])
            _build._libs.pop("geom_bias", None)
            extra = (f"; active rows bit-equal to the unskipped kernel: other "
                     f"{full['other']}, this {full['this']}")
        row = "row 3" if active is not None else "row 1"
        print(f"{row} {label}: max|exp err|, max|log err| other {errs['other'][0]:.3e}, "
              f"{errs['other'][1]:.3e}; this {errs['this'][0]:.3e}, "
              f"{errs['this'][1]:.3e}; in the band: {ok}; max|exp diff| between "
              f"the builds {diff:.3e}{extra}; ms {times}", flush=True)


def compare_geom_bias_bwd(libs, dev, rng):
    G = 16
    w = torch.tensor(rng.randn(64, G) * 0.1, dtype=torch.float32, device=dev)
    b = torch.tensor(rng.randn(G) * 0.05, dtype=torch.float32, device=dev)

    def tens(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)
    for label, pos in (
            ("C=80 N=M=100", extract_multi_position_matrix_t(
                tens(np.stack([boxes(rng, 100) for _ in range(80)], 1)))),
            ("C=1 N=316 M=300", extract_position_matrix_t(
                tens(boxes(rng, 316)), 300)[None])):
        pos = pos.contiguous()
        acc = GB.geom_acc_reference(pos, w, b)
        gout = tens(rng.randn(*acc.shape)) * ((acc > 2e-2) | (acc < -1e-3))
        outs, times = in_turns("geom_bias_bwd", libs, lambda: GB._launch_bwd(
            pos, w, b, gout, 100.0, need_pos=False)[1])
        want = GB.geom_bias_bwd_reference(pos, w, b, gout)[1]
        errs = {k: float((outs[k] - want).abs().max() / want.abs().max())
                for k in ("other", "this")}
        print(f"row 2 {label} (no d_pos): d_W max err / max other "
              f"{errs['other']:.3e}, this {errs['this']:.3e} (tol 1e-4); ms "
              f"{times}", flush=True)


COMPARE = {"bias_attention": compare_attention, "nms_kernel": compare_nms,
           "geom_bias": compare_geom_bias, "geom_bias_bwd": compare_geom_bias_bwd}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, required=True,
                    help="csrc/ directory of the other checkout")
    ap.add_argument("--only", choices=sorted(COMPARE), action="append",
                    help="compare these sources only (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_builds needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print_card()
    dev = torch.device("cuda", 0)
    for name in args.only or list(COMPARE):
        libs = {"other": build_variants(name, {"other": []}, csrc=args.other,
                                        tag="compare")["other"],
                "this": build_variants(name, {"this": []},
                                       tag="compare_this")["this"]}
        COMPARE[name](libs, dev, np.random.RandomState(0))


if __name__ == "__main__":
    main()
