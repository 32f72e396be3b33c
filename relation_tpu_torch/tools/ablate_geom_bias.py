"""Where the time of the geometric-bias forward (csrc/geom_bias.cu: rows 1
and 3) goes, on one CUDA card, by switching its parts off one at a time.

    python3 -m relation_tpu_torch.tools.ablate_geom_bias [--csrc DIR]

Builds variants of the source, each a few text substitutions away from it
(the .cu or a header beside it; tools/_ablate.py: one nvcc per variant, in
parallel), and times each with CUDA events on seeded inputs at the launch
shapes of the driven paths: 80 classes at N=M=100 (the learned-NMS head),
one class at 300x300 and 316x300 (the head's relation modules, inference and
training), 80 classes at N=M=150 (the FPN tail), and the skip form over 16
of 80 classes at N=M=150. A variant that switches a part off computes
garbage; a time marked * is from a variant whose output differs from the
full kernel's.

``--csrc DIR`` times the sources of another checkout instead. Sources of the
SIMT design (one thread a pair: 32 sincosf and the 64 x G dot in FMAs)
take that design's variants.

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
from relation_tpu_torch.ops.kernels import geom_bias as GB
from relation_tpu_torch.tools._ablate import build_variants, print_card, time_ms
from relation_tpu_torch.tools.ablate_attention import boxes

FWD, TRIG = "geom_bias.cu", "geom_trig.cuh"
SINCOS = "sincosf(__fmul_rn(pj, fr[kk]), &sn[h][kk], &cs[h][kk]);"
MMA3 = ("      f16x3::mma(d, al, bh);\n      f16x3::mma(d, ah, bl);\n"
        "      f16x3::mma(d, ah, bh);\n")
# the tensor-core design: geom_tile_acc (geom_trig.cuh) in persistent warps
VARIANTS = {
    "full": [],
    # the accurate sincosf replaced by its argument (no trig)
    "notrig": [(TRIG, SINCOS, "sn[h][kk] = cs[h][kk] = __fmul_rn(pj, fr[kk]);")],
    # the accurate sincosf replaced by the fast approximation
    "fasttrig": [(TRIG, SINCOS, "__" + SINCOS)],
    # no product on the tensor cores (the splits kept alive)
    "noproduct": [(TRIG, MMA3, "      d[0] = __uint_as_float(al[0] ^ ah[1] ^ al[2] ^ ah[3] ^ "
                               "bh[0] ^ bl[1]);\n")],
    # one f16 pass in place of three (wrong sums)
    "mma1": [(TRIG, MMA3, "      f16x3::mma(d, ah, bh);\n")],
    # two or three blocks an SM (registers capped at 128, 80)
    "blocks2": [(FWD, "constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 2;")],
    "blocks3": [(FWD, "constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 3;")],
    # no global stores (the staged outputs kept alive)
    "nostores": [(FWD, "for (int g = 0; g < G; ++g) oc[g * nm] = so[g * kSt + lane];",
                  "for (int g = 0; g < G; ++g) if (so[g * kSt + lane] == 12345.f) "
                  "oc[g * nm] = 0.f;")],
}
# the SIMT design: a thread a pair, geom_accumulate (geom_trig.cuh)
VARIANTS_SIMT = {
    "full": [],
    "notrig": [(TRIG, "sincosf(__fmul_rn(pj, kGeomFreq[k]), &s, &c);",
                "s = c = __fmul_rn(pj, kGeomFreq[k]);")],
    "fasttrig": [(TRIG, "sincosf(__fmul_rn(pj, kGeomFreq[k]), &s, &c);",
                  "__sincosf(__fmul_rn(pj, kGeomFreq[k]), &s, &c);")],
    # the 64 x G dot reduced to one add a feature
    "nodot": [(TRIG, "acc[g] = fmaf(c, b.x, fmaf(s, a.x, acc[g]));",
               "acc[g] += s + c;"),
              (TRIG, "acc[g + 1] = fmaf(c, b.y, fmaf(s, a.y, acc[g + 1]));", ""),
              (TRIG, "acc[g + 2] = fmaf(c, b.z, fmaf(s, a.z, acc[g + 2]));", ""),
              (TRIG, "acc[g + 3] = fmaf(c, b.w, fmaf(s, a.w, acc[g + 3]));", "")],
    "nostores": [(FWD, "    oc[g * nm_total] = RAW ? geom_add_bias(acc[g], sb[g])\n"
                       "                           : geom_log_clamp(acc[g], sb[g]);",
                  "    if (acc[g] == 12345.f) oc[g * nm_total] = 0.f;")],
}


def cases(dev, rng):
    """(label, pos [C, 4, N, M], active or None) at the driven shapes."""
    def tens(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    def multi(C, N):
        return extract_multi_position_matrix_t(
            tens(np.stack([boxes(rng, N) for _ in range(C)], 1))).contiguous()
    act = np.zeros(80, np.int32)
    act[rng.choice(80, 16, replace=False)] = 1
    return [("C=80 N=M=100", multi(80, 100), None),
            ("C=1 N=M=300", extract_position_matrix_t(
                tens(boxes(rng, 300)), 300)[None].contiguous(), None),
            ("C=1 N=316 M=300", extract_position_matrix_t(
                tens(boxes(rng, 316)), 300)[None].contiguous(), None),
            ("C=80 N=M=150", multi(80, 150), None),
            ("skip C=80 N=M=150 active 16", multi(80, 150),
             torch.tensor(act, device=dev))]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", type=Path, default=None,
                    help="csrc/ directory of another checkout (default: this one)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate_geom_bias needs a CUDA card")
    print_card()
    tc = "geom_tile_acc" in ((args.csrc or _build.CSRC) / TRIG).read_text()
    libs = build_variants("geom_bias", VARIANTS if tc else VARIANTS_SIMT,
                          csrc=args.csrc)
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    G = 16
    w = torch.tensor(rng.randn(64, G) * 0.1, dtype=torch.float32, device=dev)
    b = torch.tensor(rng.randn(G) * 0.05, dtype=torch.float32, device=dev)
    for label, pos, active in cases(dev, rng):
        def call():
            return GB._launch(pos, w, b, 100.0, active=active)
        row, want = [], None
        for var, lib in libs.items():
            _build._libs["geom_bias"] = lib
            out = call()
            out = out if active is None else out[active.bool()]
            want = out if want is None else want
            mark = "" if torch.equal(out, want) else "*"
            row.append(f"{var} {time_ms(call):.4f}{mark}")
        _build._libs.pop("geom_bias", None)
        print(f"geom_bias {label}: " + "; ".join(row), flush=True)


if __name__ == "__main__":
    main()
